"""Request batching and HTTP serving (counterpart of
gandtr_tpu/serving/service.py).

`BatchingService` collects concurrent requests (up to `max_batch`, or until
`max_wait_ms` passes), runs ONE forward for them and fans the rows back out.
`serve_http` is a stdlib ThreadingHTTPServer: npy, JPEG or PNG image in;
out, a JSON descriptor from an embedding model or an `image/png` from a
generator. Endpoints: GET /healthz, GET /v1/models,
POST /v1/models/<name>:predict. (`:search` and the native decoder are not
ported yet.)
"""
import io
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

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
    """bytes -> uint8 (H, W, 3) RGB: npy as it is, anything else via PIL."""
    if content_type == "application/octet-stream" or body[:6] == b"\x93NUMPY":
        arr = np.load(io.BytesIO(body), allow_pickle=False)
        if not (arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3):
            raise ValueError("npy body must be uint8 (H, W, 3) RGB, got %s %s"
                             % (arr.dtype, arr.shape))
        return arr
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))


def encode_png(img):
    """uint8 (H, W, 3) RGB -> PNG bytes (PIL, default compression)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.asarray(img)).save(buf, format="PNG")
    return buf.getvalue()


def _fit_to_servable(img, meta):
    """Resize a decoded uint8 image to the servable's fixed (H, W)."""
    h, w = meta["image_hw"]
    if img.shape[:2] == (h, w):
        return img
    from PIL import Image
    return np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))


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
        path = self.path.partition("?")[0]
        if not (path.startswith("/v1/models/") and path.endswith(":predict")):
            return self._send(404, {"error": "not found"})
        name = path[len("/v1/models/"):-len(":predict")]
        entry = self.server.models.get(name)
        if entry is None:
            return self._send(404, {"error": "unknown model %r" % name})
        try:  # client-side problems: undecodable or malformed body
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            img = _decode_image_bytes(body,
                                      self.headers.get("Content-Type", ""))
            x = _fit_to_servable(img, entry.meta)
        except Exception as e:
            return self._send(400, {"error": "%s: %s" % (type(e).__name__, e)})
        try:  # server-side problems: device or batcher failures are 5xx
            out = entry.batcher.submit(x).result(timeout=600)
        except Exception as e:
            return self._send(500, {"error": "%s: %s" % (type(e).__name__, e)})
        if entry.meta["kind"] == "embedding":
            return self._send(200, {"descriptor": [float(v) for v in out]})
        self._send(200, encode_png(out), ctype="image/png")


class _ModelEntry:
    def __init__(self, servable, max_batch, max_wait_ms):
        self.meta = servable.meta
        self.batcher = BatchingService(servable, max_batch=max_batch,
                                       max_wait_ms=max_wait_ms)


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
               max_wait_ms=5.0, block=True, device=None):
    """Serve `models` ({name: Servable}) over HTTP.

    Runs on `cuda` unless `device="cpu"`; every servable must live on that
    device. With block=False returns the started server (`.server_address`,
    `.close()`); its batchers are in `.models`."""
    dev = resolve_device(device)
    entries = {}
    for name, servable in models.items():
        if servable.device.type != dev.type:
            raise ValueError("model %r lives on %s, the server on %s"
                             % (name, servable.device, dev))
        cap = max_batch or servable.buckets[-1]
        entries[name] = _ModelEntry(servable, cap, max_wait_ms)

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
