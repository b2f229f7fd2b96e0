"""ctypes bindings for the native image decoder (loader.cc; counterpart of
gandtr_tpu/native/__init__.py).

libjpeg / libpng decode (with DCT-domain scaling for the 1024px eval
protocol) on a std::thread worker pool, one ctypes call a batch, so the
GIL is released for the whole batch. The decode is byte-equal to PIL's
(`Image.open(p).convert("RGB")`).

The library is built at first use, as the CUDA kernels are
(kernels/_build.py), into the ignored `gandtr_tpu_torch/_build/`:

    g++ -O3 -std=c++17 -fPIC -shared -o lib<...>.so loader.cc \
        -ljpeg -lpng -lpthread

keyed on a hash of the source and the flags; nothing built is committed.
Where the compiler or the libjpeg / libpng headers are missing,
`available()` is False, `build_error()` says why, and every caller decodes
with PIL, to the same pixels.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "loader.cc"
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared"]
LIBS = ["-ljpeg", "-lpng", "-lpthread"]
ABI_VERSION = 1

_lib = None
_build_err = None
_lock = threading.Lock()

# error codes mirroring loader.cc
OK, E_OPEN, E_FORMAT, E_DECODE, E_UNSUPPORTED, E_NOMEM = range(6)


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / ("libgandtr_native_%s.so" % h.hexdigest()[:16])


def _build(so):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name("%s.%d.tmp" % (so.name, os.getpid()))
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           *LIBS], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise RuntimeError("native build failed:\n%s"
                           % (proc.stderr or proc.stdout)[-2000:])
    os.replace(tmp, so)


def _load():
    global _lib, _build_err
    with _lock:
        if _lib is not None or _build_err is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                # built elsewhere, against libraries this machine lacks:
                # build it here once more
                _build(so)
                lib = ctypes.CDLL(str(so))
            u8p = ctypes.POINTER(ctypes.c_ubyte)
            lib.gandtr_decode.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(u8p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int]
            lib.gandtr_decode.restype = ctypes.c_int
            lib.gandtr_free.argtypes = [u8p]
            lib.gandtr_free.restype = None
            lib.gandtr_pool_create.argtypes = [ctypes.c_int]
            lib.gandtr_pool_create.restype = ctypes.c_void_p
            lib.gandtr_pool_destroy.argtypes = [ctypes.c_void_p]
            lib.gandtr_pool_destroy.restype = None
            lib.gandtr_pool_decode_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.POINTER(u8p),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            lib.gandtr_pool_decode_batch.restype = None
            if lib.gandtr_native_abi_version() != ABI_VERSION:
                raise RuntimeError("native library ABI %d != %d"
                                   % (lib.gandtr_native_abi_version(),
                                      ABI_VERSION))
            _lib = lib
        except Exception as exc:  # no compiler or headers: PIL decodes
            _build_err = exc
        return _lib


def available():
    """True when the native library built and loaded."""
    return _load() is not None


def build_error():
    """Why the library is not available (None when it is)."""
    _load()
    return _build_err


def _to_array(lib, buf, h, w):
    arr = np.ctypeslib.as_array(buf, shape=(h, w, 3)).copy()
    lib.gandtr_free(buf)
    return arr


def decode(path, scale_longest=0):
    """A JPEG / PNG as an (H, W, 3) uint8 RGB array, or None where the
    native path cannot take it (the caller decodes with PIL then).

    scale_longest > 0 decodes a JPEG at the smallest 1/8-granular DCT scale
    whose longest side still covers it (PIL's `Image.draft` semantics)."""
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_ubyte)()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.gandtr_decode(os.fsencode(path), ctypes.byref(buf),
                           ctypes.byref(h), ctypes.byref(w),
                           int(scale_longest))
    if rc != OK:
        return None
    return _to_array(lib, buf, h.value, w.value)


class DecodePool:
    """The C++ worker pool: whole batches decoded in one GIL-released
    call. `close()` waits for the batches in flight, and exactly one
    caller destroys the pool."""

    def __init__(self, n_threads=None):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable: %r" % _build_err)
        self._lib = lib
        n = int(n_threads or min(16, os.cpu_count() or 4))
        self._pool = lib.gandtr_pool_create(n)
        self.n_threads = n
        self._cv = threading.Condition()
        self._inflight = 0

    def decode_batch(self, paths, scale_longest=0):
        """Decode `paths` concurrently: a list of (H, W, 3) uint8 arrays,
        None where one failed (the reference's `ignore_errors`)."""
        n = len(paths)
        if n == 0:
            return []
        with self._cv:
            if self._pool is None:
                raise RuntimeError("pool closed")
            self._inflight += 1
            pool = self._pool
        try:
            lib = self._lib
            c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
            outs = (ctypes.POINTER(ctypes.c_ubyte) * n)()
            hs, ws, rcs = ((ctypes.c_int * n)() for _ in range(3))
            lib.gandtr_pool_decode_batch(pool, c_paths, n, outs, hs, ws,
                                         int(scale_longest), rcs)
        finally:
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()
        return [_to_array(lib, outs[i], hs[i], ws[i])
                if rcs[i] == OK and outs[i] else None for i in range(n)]

    def close(self):
        with self._cv:
            if self._pool is None:
                return
            pool, self._pool = self._pool, None
            while self._inflight:
                self._cv.wait()
        self._lib.gandtr_pool_destroy(pool)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_shared_pool = None
# its own lock: DecodePool() takes _lock through _load()
_pool_lock = threading.Lock()


def shared_pool():
    """The process-wide pool."""
    global _shared_pool
    with _pool_lock:
        if _shared_pool is None:
            _shared_pool = DecodePool()
        return _shared_pool
