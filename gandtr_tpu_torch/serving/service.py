"""Request batching and HTTP serving (counterpart of
gandtr_tpu/serving/service.py).

`BatchingService` collects concurrent requests (up to `max_batch`, or until
`max_wait_ms` passes), runs ONE forward for them and fans the rows back out.
`serve_http` is a stdlib ThreadingHTTPServer: npy, JPEG or PNG image in;
out, a JSON descriptor from an embedding model or an `image/png` from a
generator. Endpoints: GET /healthz, GET /v1/models,
POST /v1/models/<name>:predict and, for an embedding model with an index
(`indices[name]`, a RetrievalIndex or PQRetrievalIndex),
POST /v1/models/<name>:search?k=10 (image in, the top k {name, score}
out). A model is an artifact directory, a loaded artifact or an
in-memory `Servable`. JPEG and PNG bodies decode with the native decoder
(native/) where it built, else with PIL, to the same pixels
(`GANDTR_TPU_NATIVE_LOADER=0` turns the native path off).
"""
import io
import json
import os
import queue
import tempfile
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np
import torch

from gandtr_tpu_torch.device import resolve_device

_STOP = object()


class BatchingService:
    """Micro-batches concurrent `submit` calls into single `fn` invocations.
    `fn` takes stacked (N, ...) arrays and returns an (N, ...) array; each
    submit returns a Future of its output row. `batches` counts the batches
    formed."""

    def __init__(self, fn, max_batch=8, max_wait_ms=5.0):
        self.fn = fn
        self.batches = 0
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._q = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, *arrays):
        fut = Future()
        # under the lock, so that no item lands behind the _STOP sentinel
        with self._lock:
            if self._closed:
                raise RuntimeError("service closed")
            self._q.put((tuple(np.asarray(a) for a in arrays), fut))
        return fut

    def __call__(self, *arrays):
        return self.submit(*arrays).result()

    def _loop(self):
        stop = False
        while not stop:
            item = self._q.get()
            if item is _STOP:
                return
            batch = [item]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
            self._run(batch)

    @staticmethod
    def _resolve(fut, value=None, error=None):
        """Set a future's outcome, tolerating waiters that gave up: an
        InvalidStateError here would kill the batcher thread."""
        try:
            if error is not None:
                fut.set_exception(error)
            else:
                fut.set_result(value)
        except Exception:
            pass

    def _run(self, batch):
        futs = [f for _, f in batch]
        self.batches += 1
        try:
            nargs = len(batch[0][0])
            stacked = [np.stack([item[0][j] for item in batch])
                       for j in range(nargs)]
            outs = np.asarray(self.fn(*stacked))
            if outs.shape[0] != len(batch):
                raise RuntimeError("batch of %d gave %d outputs"
                                   % (len(batch), outs.shape[0]))
        except Exception as e:  # fan the failure out to every waiter
            for f in futs:
                self._resolve(f, error=e)
            return
        for i, f in enumerate(futs):
            self._resolve(f, value=outs[i])

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_STOP)
        self._thread.join(timeout=10)
        # fail any stragglers the worker skipped; if the join timed out and
        # the drain takes the sentinel, put it back for the worker
        drained_stop = False
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                drained_stop = True
            else:
                self._resolve(item[1], error=RuntimeError("service closed"))
        if drained_stop and self._thread.is_alive():
            self._q.put(_STOP)


def _decode_image_bytes(body, content_type):
    """bytes -> uint8 (H, W, 3) RGB: npy as it is, JPEG and PNG through
    the native decoder where it built, anything else via PIL."""
    if content_type == "application/octet-stream" or body[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if not (arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3):
            raise ValueError("npy body must be uint8 (H, W, 3) RGB, got %s %s"
                             % (arr.dtype, arr.shape))
        return arr
    from gandtr_tpu_torch import native
    if os.environ.get("GANDTR_TPU_NATIVE_LOADER", "1") != "0" \
            and native.available():
        fd, tmp = tempfile.mkstemp(suffix=".img")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(body)
            arr = native.decode(tmp)
            if arr is not None:
                return arr
        finally:
            os.unlink(tmp)
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def encode_png(img):
    """uint8 (H, W, 3) RGB -> PNG bytes (PIL, default compression)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.asarray(img)).save(buf, format="PNG")
    return buf.getvalue()


def _fit_to_artifact(img, meta):
    """A decoded uint8 image fitted to the artifact's fixed (H, W) ->
    (image, mask or None).

    A masked artifact keeps the aspect ratio: the image scales to fit,
    its bottom and right are padded with edge pixels, and the mask marks
    the valid rows and columns (masked GeM leaves the padding out). An
    unmasked artifact takes the image resized to exactly (H, W)."""
    from PIL import Image
    h, w = meta["image_hw"]
    if not meta["with_mask"]:
        if img.shape[:2] == (h, w):
            return img, None
        return np.asarray(Image.fromarray(img).resize((w, h),
                                                      Image.BILINEAR)), None
    pil = Image.fromarray(img)
    scale = min(h / pil.height, w / pil.width)
    nh = max(1, min(h, round(pil.height * scale)))
    nw = max(1, min(w, round(pil.width * scale)))
    small = np.asarray(pil.resize((nw, nh), Image.BILINEAR))
    out = np.pad(small, [(0, h - nh), (0, w - nw), (0, 0)], mode="edge")
    mask = np.zeros((h, w), np.float32)
    mask[:nh, :nw] = 1.0
    return out, mask


def _quantize_on_host(out, meta):
    """A float32 generator output (an artifact with from_uint8=False) ->
    uint8, the host form of device_quantize_rgb."""
    mean = np.asarray(meta["mean_std"][0], np.float32)
    std = np.asarray(meta["mean_std"][1], np.float32)
    rgb = np.clip(out * std + mean, 0, 1)
    return np.floor(rgb * 255.0).astype(np.uint8)


class _Handler(BaseHTTPRequestHandler):
    server_version = "gandtr-tpu-torch-serving"

    def log_message(self, fmt, *args):  # quiet; the service layer logs
        pass

    def _send(self, code, payload, ctype="application/json"):
        body = (json.dumps(payload).encode() if ctype == "application/json"
                else payload)
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            dev = self.server.device
            self._send(200, {
                "status": "ok", "backend": "torch", "device": str(dev),
                "device_name": (torch.cuda.get_device_name(dev)
                                if dev.type == "cuda" else "cpu"),
                "devices": (torch.cuda.device_count()
                            if dev.type == "cuda" else 1)})
        elif self.path == "/v1/models":
            self._send(200, {name: e.meta for name, e
                             in self.server.models.items()})
        else:
            self._send(404, {"error": "not found"})

    def do_POST(self):
        path, _, qs = self.path.partition("?")
        action = next((a for a in (":predict", ":search")
                       if path.startswith("/v1/models/")
                       and path.endswith(a)), None)
        if action is None:
            return self._send(404, {"error": "not found"})
        name = path[len("/v1/models/"):-len(action)]
        entry = self.server.models.get(name)
        if entry is None:
            return self._send(404, {"error": "unknown model %r" % name})
        if action == ":search" and entry.index is None:
            return self._send(404, {"error": "model %r has no search index"
                                    % name})
        try:  # client-side problems: a bad k, an undecodable body
            if action == ":search":
                k = int(parse_qs(qs).get("k", ["10"])[0])
                if k < 1:
                    raise ValueError("k must be >= 1, got %d" % k)
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            img = _decode_image_bytes(body,
                                      self.headers.get("Content-Type", ""))
            x, mask = _fit_to_artifact(img, entry.meta)
            x = entry.prepare(x)
        except Exception as e:
            return self._send(400, {"error": "%s: %s" % (type(e).__name__, e)})
        try:  # server-side problems: device, batcher or index failures
            args = (x,) if mask is None else (x, mask)
            out = entry.batcher.submit(*args).result(timeout=600)
            if action == ":search":
                results = entry.index.query(np.asarray(out)[None], k=k)[0]
        except Exception as e:
            return self._send(500, {"error": "%s: %s" % (type(e).__name__, e)})
        if action == ":search":
            return self._send(200, {"results": [{"name": n, "score": s}
                                                for n, s in results]})
        if entry.meta["kind"] == "embedding":
            return self._send(200, {"descriptor": [float(v) for v in out]})
        out = np.asarray(out)
        if out.dtype != np.uint8:
            out = _quantize_on_host(out, entry.meta)
        self._send(200, encode_png(out), ctype="image/png")


class _ModelEntry:
    def __init__(self, servable, max_batch, max_wait_ms, index=None):
        self.meta = servable.meta
        self.index = index
        self.batcher = BatchingService(servable, max_batch=max_batch,
                                       max_wait_ms=max_wait_ms)
        # an artifact with from_uint8=False takes the normalized float32
        # image: the host pipeline is rebuilt from the artifact's own
        # provenance (its transforms and mean_std)
        self._host_tf = None
        if self.meta["input_dtype"] == "float32":
            from gandtr_tpu_torch.data.transforms import initialize_transforms
            self._host_tf = initialize_transforms(self.meta["transforms"],
                                                  self.meta["mean_std"])

    def prepare(self, img_u8):
        """A decoded, fitted uint8 (H, W, 3) -> the artifact's input."""
        if self._host_tf is None:
            return img_u8
        from PIL import Image
        return np.asarray(self._host_tf(Image.fromarray(img_u8)),
                          np.float32)


class _Server(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, models, device):
        super().__init__(address, _Handler)
        self.models = models
        self.device = device

    def close(self):
        """Stop serving (from another thread than serve_forever's), close
        the socket and the batchers."""
        self.shutdown()
        self.server_close()
        for e in self.models.values():
            e.batcher.close()


def serve_http(models, host="127.0.0.1", port=0, max_batch=None,
               max_wait_ms=5.0, block=True, device=None, indices=None):
    """Serve `models` ({name: artifact directory, loaded artifact or
    in-memory Servable}) over HTTP, with `indices` ({name: index}) behind
    `:search` for embedding models.

    Runs on `cuda` unless `device="cpu"`; an artifact path loads there, and
    every servable must live on that device. With block=False returns the
    started server (`.server_address`, `.close()`); its batchers are in
    `.models`."""
    from gandtr_tpu_torch.serving.export import load_artifact
    dev = resolve_device(device)
    indices = dict(indices or {})
    unknown = sorted(set(indices) - set(models))
    if unknown:
        raise ValueError("indices for unknown models %s" % unknown)
    entries = {}
    for name, servable in models.items():
        if isinstance(servable, (str, os.PathLike)):
            servable = load_artifact(os.fspath(servable), device=dev)
        if servable.device.type != dev.type:
            raise ValueError("model %r lives on %s, the server on %s"
                             % (name, servable.device, dev))
        if name in indices and servable.meta["kind"] != "embedding":
            raise ValueError("model %r is a %s: only an embedding model "
                             "takes a search index"
                             % (name, servable.meta["kind"]))
        cap = max_batch or servable.buckets[-1]
        entries[name] = _ModelEntry(servable, cap, max_wait_ms,
                                    index=indices.get(name))

    server = _Server((host, port), entries, dev)
    if not block:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server
    try:
        server.serve_forever()
    finally:
        server.server_close()
        for e in entries.values():
            e.batcher.close()
