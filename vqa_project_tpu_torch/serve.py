"""Online inference serving: dynamic batching over one fixed-shape forward.

Counterpart of ``vqa_project_tpu/serve.py`` (single device):

- requests are padded into one fixed (batch_size, T) / (batch_size, K,
  feat) batch, so every batch runs the same shapes;
- a worker thread drains the request queue, waiting at most
  ``max_wait_ms`` for the batch to fill;
- image features are looked up on the host from the dataset's
  FeatureStore, or supplied with the request;
- the forward, the softmax and the top-k run on ``device`` (CUDA by
  default, where the graph kernels launch).

Thread-safety: torch work happens on the worker thread only (and in
the constructor's warmup, before the worker starts); submitters block on
a per-request Future.
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vqa_project_tpu_torch.config import resolve_device
from vqa_project_tpu_torch.data.text import tokenize


@dataclass
class _Request:
    tokens: np.ndarray          # (T,) int32, already padded/truncated
    qlen: int
    features: np.ndarray        # (K, feat_dim - 4)
    boxes: np.ndarray           # (K, 4)
    future: Future = field(default_factory=Future)


class InferenceServer:
    """Dynamic-batching VQA inference over a GraphVQAModel.

    model: a ``models.GraphVQAModel``; it is moved to ``device``.
    ds: any object with ``q_wtoi`` (word -> id), ``a_itow`` (id ->
        answer), ``n_answers``, ``max_qlen``, ``n_obj``, ``feat_dim`` and
        ``store`` (a FeatureStore-like object with ``features``,
        ``boxes`` and ``id_to_row``).
    """

    def __init__(self, model, ds, *, device="cuda", batch_size: int = 16,
                 max_wait_ms: float = 5.0, top_k: int = 5):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.ds = ds
        self.batch_size = int(batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.top_k = int(min(top_k, ds.n_answers - 1))
        self._shapes = (ds.max_qlen, ds.n_obj, ds.feat_dim)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._stop = threading.Event()
        self.batches_served = 0
        self.requests_served = 0

        # warm up before accepting work: the first forward builds the
        # CUDA kernels, and the synchronize makes sure it really ran
        t, k, fdim = self._shapes
        t0 = time.monotonic()
        self._forward(np.zeros((self.batch_size, t), np.int32),
                      np.zeros((self.batch_size, k, fdim), np.float32),
                      np.ones((self.batch_size,), np.int32))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_s = time.monotonic() - t0
        if self.warmup_s > 5:
            print(f"forward warm after {self.warmup_s:.0f}s (kernel build)",
                  file=sys.stderr)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _forward(self, q: np.ndarray, image: np.ndarray,
                 qlen: np.ndarray):
        """Top-k (probs, answer ids) of one padded batch, as numpy."""
        dev = self.device
        with torch.inference_mode():
            logits, _, _ = self.model(
                torch.from_numpy(q).to(dev),
                torch.from_numpy(image).to(dev),
                torch.from_numpy(qlen).to(dev))
            # column n_answers-1 is the padding answer slot, never servable
            logits[:, -1] = float("-inf")
            probs = torch.softmax(logits.float(), dim=-1)
            vals, idxs = torch.topk(probs, self.top_k, dim=-1)
            return vals.cpu().numpy(), idxs.cpu().numpy()

    # ---------------- public API ----------------

    def submit(self, question: str,
               image_id: Optional[str] = None,
               features: Optional[np.ndarray] = None,
               boxes: Optional[np.ndarray] = None) -> Future:
        """Queue one request; the Future resolves to the response dict."""
        t, k, fdim = self._shapes
        toks = np.zeros((t,), np.int32)
        words = tokenize(question)[:t]
        for i, w in enumerate(words):
            toks[i] = self.ds.q_wtoi.get(w, 0)
        qlen = max(1, len(words))

        if features is None:
            if image_id is None:
                raise ValueError("need image_id or features")
            id_to_row = self.ds.store.id_to_row
            row = id_to_row.get(image_id, id_to_row.get(str(image_id)))
            if row is None:
                raise KeyError(f"unknown image_id {image_id!r}")
            features = np.asarray(self.ds.store.features[row])
            boxes = np.asarray(self.ds.store.boxes[row])
        features = np.asarray(features, np.float32)
        boxes = np.asarray(boxes, np.float32)
        if features.shape != (k, fdim - 4) or boxes.shape != (k, 4):
            raise ValueError(
                f"features/boxes must be {(k, fdim - 4)}/{(k, 4)}, got "
                f"{features.shape}/{boxes.shape}")

        req = _Request(toks, qlen, features, boxes)
        self._queue.put(req)
        return req.future

    def predict(self, question: str, timeout: Optional[float] = 60.0,
                **kw) -> Dict[str, Any]:
        """Blocking submit(); timeout bounds the wait so a wedged worker
        surfaces as concurrent.futures.TimeoutError instead of a hang."""
        return self.submit(question, **kw).result(timeout)

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)

    # ---------------- worker ----------------

    def _drain(self) -> List[_Request]:
        """Block for one request, then take more until the batch fills
        or max_wait_ms passes."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while len(batch) < self.batch_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=left))
            except queue.Empty:
                break
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            try:
                self._serve_batch(batch)
            except Exception as e:
                # fail THIS batch's futures and keep the worker alive, or
                # every later predict() would block on a dead thread
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def pad_batch(self, batch: List[_Request]):
        """The fixed-shape (q, image, qlen) arrays for up to batch_size
        requests; unused rows are zeros with qlen 1."""
        t, k, fdim = self._shapes
        b = self.batch_size
        q = np.zeros((b, t), np.int32)
        qlen = np.ones((b,), np.int32)
        image = np.zeros((b, k, fdim), np.float32)
        for i, r in enumerate(batch):
            q[i] = r.tokens
            qlen[i] = r.qlen
            image[i, :, :fdim - 4] = r.features
            image[i, :, fdim - 4:] = r.boxes
        return q, image, qlen

    def _serve_batch(self, batch: List[_Request]):
        vals, idxs = self._forward(*self.pad_batch(batch))
        self.batches_served += 1
        self.requests_served += len(batch)
        for i, r in enumerate(batch):
            top = [{"answer": self.ds.a_itow.get(int(j), "<unk>"),
                    "prob": float(v)}
                   for j, v in zip(idxs[i], vals[i])]
            r.future.set_result(
                {"answer": top[0]["answer"], "top_k": top,
                 "batch_size": len(batch)})


# ---------------- HTTP front-end ----------------


def make_http_server(server: InferenceServer, port: int = 0,
                     host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """POST /predict {"question": ..., "image_id"} or
    {"question": ..., "features", "boxes"}
    -> {"answer", "top_k", "batch_size"}; GET /healthz -> stats.
    Returns the (not yet serving) ThreadingHTTPServer; call
    serve_forever() from a thread. port=0 picks a free port (read it
    from .server_address)."""

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keeps connections open between requests; safe because
        # _json always sends Content-Length
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "ok": True,
                    "requests_served": server.requests_served,
                    "batches_served": server.batches_served,
                    "batch_size": server.batch_size,
                    "warmup_s": round(server.warmup_s, 3)})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            # drain the body BEFORE any response: under keep-alive an
            # unread body would be parsed as the next request line
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                n = 0
            body = self.rfile.read(n) if n > 0 else b""
            if self.path != "/predict":
                self._json(404, {"error": "unknown path"})
                return
            try:
                payload = json.loads(body or b"{}")
                kw = {}
                if "features" in payload:
                    if "boxes" not in payload:
                        raise ValueError(
                            "\"features\" requires \"boxes\" "
                            "(K x 4 normalized xyxy)")
                    kw["features"] = np.asarray(payload["features"],
                                                np.float32)
                    kw["boxes"] = np.asarray(payload["boxes"], np.float32)
                else:
                    kw["image_id"] = payload.get("image_id")
                out = server.predict(payload["question"], **kw)
                self._json(200, out)
            except (KeyError, ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
            except Exception as e:  # forward/runtime failure -> 500
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    class Server(ThreadingHTTPServer):
        # the stdlib listen backlog of 5 resets bursts of connects
        request_queue_size = 128

    return Server((host, port), Handler)
