"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` compiles, with a plain C interface, into
`gandtr_tpu_torch/_build/lib<name>_<hash>.so` (a directory git ignores):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v

The hash covers the source, the shared headers (`csrc/*.cuh`) and the
flags, so a changed source or header rebuilds and an unchanged one loads
what is already built. Nothing links libcuda: the conv kernels' TMA tensor
maps are encoded by `cuTensorMapEncodeTiled`, which the libraries take from
the runtime's driver entry point (`cudaGetDriverEntryPoint`), and they opt
in to their dynamic shared memory (above 48 KB) themselves. Never `--use_fast_math`: the CLAHE kernels must
round exactly as cv2 does. `build(names)` starts one nvcc for each source
that needs it, all together, and waits for them; the compiler's output
(with ptxas's register and shared-memory report) is kept beside each
library as `<lib>.log`.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _nvcc():
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in %s and on PATH)" % path)
    return found


def library_path(name):
    h = hashlib.sha256((CSRC / ("%s.cu" % name)).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / ("lib%s_%s.so" % (name, digest))


def build(names):
    """Compile every source in `names` that is not built yet, in parallel.
    Returns {name: library path}; raises with the compiler's output if any
    build fails."""
    out = {name: library_path(name) for name in names}
    todo = {name: so for name, so in out.items() if not so.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, so in todo.items():
        tmp = so.with_name("%s.%d.tmp" % (so.name, os.getpid()))
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / ("%s.cu" % name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        so = todo[name]
        so.with_name(so.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append("%s (rc %d):\n%s" % (name, proc.returncode, log))
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name):
    """The ctypes handle of `csrc/<name>.cu`, built if it is not yet."""
    return ctypes.CDLL(str(build([name])[name]))
