"""Micro-batching inference server for the talking-face pipeline.

The port's own copy of the serving front end (the JAX package's
``server.py`` is not imported): concurrent single-clip requests are collected
into the pipeline's batch tier and dispatched as one batched pipeline call on
the GPU.

Design:
  - Requests must match the tier's per-clip shapes exactly; only the BATCH
    axis is elastic. A ragged final group is padded by repeating rows, and
    padded rows are dropped on the way out.
  - One worker thread owns the device, so ordering is deterministic and the
    queue depth observable. HTTP handler threads block on a per-request
    event.
  - Randomness is deterministic and auditable: batch i runs with a
    ``torch.Generator`` seeded by ``batch_seed(seed, i)``, never wall-clock
    entropy.

Protocol (stdlib-only, numpy .npz both directions):
  POST /synthesize   body = npz{masked_frames[F,H,W,3], audio[T,D],
                               identity[H,W,3], class_label scalar int}
                     reply = npz{frames[F,H,W,3] float32 in [-1, 1]}
  GET  /healthz      JSON liveness + tier description
  GET  /stats        JSON counters (requests, batches, occupancy, latency)
"""
from __future__ import annotations

import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "BadRequest",
    "MicroBatcher",
    "Overloaded",
    "PipelineServer",
    "batch_seed",
    "make_pipeline_runner",
]


class Overloaded(RuntimeError):
    """Raised by MicroBatcher.submit when the queue-depth cap is hit —
    load shedding at admission, mapped to HTTP 503 by PipelineServer."""


class BadRequest(ValueError):
    """Client-fault errors (unparseable body, tier-shape mismatch) — the ONLY
    exception PipelineServer maps to HTTP 400. Server-side failures that
    happen to raise ValueError/KeyError (a shape error inside run_batch) stay
    500s: mapping them to 400 would blame the client for a server
    misconfiguration and suppress retries. Subclasses ValueError so callers catching ValueError still work."""


def batch_seed(seed: int, batch_index: int) -> int:
    """The generator seed batch ``batch_index`` runs with (deterministic
    serving): a fixed odd multiplier spreads neighbouring server seeds so
    that (seed, index) pairs do not collide on seed + index."""
    return (seed * 0x9E3779B97F4A7C15 + batch_index) % (1 << 63)


@dataclass
class _Pending:
    inputs: Dict[str, np.ndarray]
    done: threading.Event = field(default_factory=threading.Event)
    # set by a timed-out/disconnected submitter: the worker drops the request
    # at collect time instead of burning a device batch on an answer nobody
    # will read (cancellation is best-effort — a request already inside a
    # dispatched batch completes with it)
    cancelled: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[Exception] = None
    enqueued_at: float = field(default_factory=time.monotonic)


class MicroBatcher:
    """Collects concurrent single-clip requests into device-batch calls.

    `run_batch(stacked: dict[str, np.ndarray], batch_index: int)` receives
    arrays whose leading axis is exactly `batch_size` (ragged groups are
    padded by repeating the final row) and returns an array whose leading
    axis is `batch_size`; row j of the output answers request j.

    The worker dispatches as soon as the batch is full, or `max_wait_ms`
    after the FIRST pending request — latency is bounded even at occupancy 1.
    """

    def __init__(self, run_batch: Callable[[Dict[str, np.ndarray], int], np.ndarray],
                 batch_size: int, max_wait_ms: float = 50.0,
                 max_queue: Optional[int] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.run_batch = run_batch
        self.batch_size = batch_size
        self.max_wait = max_wait_ms / 1e3
        self.max_queue = max_queue  # admission cap; None = unbounded
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # counters (read under _lock via stats())
        self.n_requests = 0
        self.n_batches = 0
        self.n_rows_real = 0
        self.n_cancelled = 0
        self.n_shed = 0
        self._latencies: List[float] = []  # bounded: last 512 request latencies
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatcher")
        self._worker.start()

    # -- client side -------------------------------------------------------
    def submit(self, inputs: Dict[str, np.ndarray],
               timeout: Optional[float] = None) -> np.ndarray:
        """Blocking: enqueue one clip, wait for its row of the batch output.

        Raises Overloaded when the queue-depth cap is hit (load shedding at
        admission — cheaper for everyone than queueing work that will time
        out anyway) and TimeoutError when the deadline passes first; a
        timed-out request is CANCELLED, so the worker drops it instead of
        dispatching a device batch for a client that already got its 504."""
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is shut down")
        if self.max_queue is not None and self._q.qsize() >= self.max_queue:
            with self._lock:
                self.n_shed += 1
            raise Overloaded(
                f"queue depth >= {self.max_queue}; retry later")
        p = _Pending(inputs)
        self._q.put(p)
        if (self._stop.is_set() and not self._worker.is_alive()
                and not p.done.is_set()):
            # closes the submit/shutdown race: if shutdown's drain finished
            # between our is_set check and the put, nobody will ever complete
            # p — fail it here instead of hanging until the timeout. The
            # worker-liveness guard keeps this from firing on a request the
            # worker already collected and WILL complete (a live worker either
            # processes p or exits, after which shutdown's post-join drain
            # fails it; done.set() is idempotent either way).
            p.error = RuntimeError("MicroBatcher is shut down")
            p.done.set()
        if not p.done.wait(timeout):
            p.cancelled.set()
            with self._lock:
                self.n_cancelled += 1
            raise TimeoutError("synthesis request timed out")
        if p.result is not None:
            # result wins over a spurious shutdown-race error write: if the
            # worker completed the batch, the computed frames ARE the answer
            return p.result
        if p.error is not None:
            raise p.error
        return p.result

    def shutdown(self):
        self._stop.set()
        self._worker.join(timeout=5.0)
        # fail anything still queued rather than hanging its handler thread
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                break
            p.error = RuntimeError("server shutting down")
            p.done.set()

    def stats(self) -> Dict[str, float]:
        with self._lock:
            lat = sorted(self._latencies)
            occ = (self.n_rows_real / (self.n_batches * self.batch_size)
                   if self.n_batches else 0.0)
            pct = (lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]
                   if lat else 0.0)
            return {
                "requests": self.n_requests,
                "batches": self.n_batches,
                "batch_size": self.batch_size,
                "mean_occupancy": round(occ, 4),
                "queue_depth": self._q.qsize(),
                "cancelled": self.n_cancelled,
                "shed": self.n_shed,
                "latency_p50_s": round(pct(0.50), 4),
                "latency_p95_s": round(pct(0.95), 4),
            }

    # -- worker side -------------------------------------------------------
    def _get_live(self, timeout: float) -> Optional[_Pending]:
        """One queue pop that silently discards cancelled requests (their
        submitters have already raised TimeoutError and gone away)."""
        p = self._q.get(timeout=timeout)  # propagates queue.Empty
        if p.cancelled.is_set():
            p.done.set()
            return None
        return p

    def _collect(self) -> List[_Pending]:
        """Block for the first request, then fill until full or deadline."""
        try:
            first = self._get_live(timeout=0.1)
        except queue.Empty:
            return []
        if first is None:
            return []
        group = [first]
        deadline = time.monotonic() + self.max_wait
        while len(group) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                p = self._get_live(timeout=remaining)
            except queue.Empty:
                break
            if p is not None:
                group.append(p)
        return group

    def _loop(self):
        batch_index = 0
        while not self._stop.is_set():
            group = self._collect()
            if not group:
                continue
            n_real = len(group)
            try:
                # pad the ragged tail by repeating the last row; padded rows
                # are sliced off below, so they only cost device time, never
                # results. Assembly lives INSIDE the try: direct MicroBatcher
                # users can submit mismatched keys/shapes, and a KeyError/
                # ValueError here must fail this group, not kill the one
                # dispatcher thread (which would hang every future submit
                # while /healthz keeps reporting ok).
                rows = group + [group[-1]] * (self.batch_size - n_real)
                stacked = {
                    k: np.stack([r.inputs[k] for r in rows])
                    for k in group[0].inputs
                }
                out = np.asarray(self.run_batch(stacked, batch_index))
                if out.shape[0] != self.batch_size:
                    raise RuntimeError(
                        f"run_batch returned leading axis {out.shape[0]}, "
                        f"expected {self.batch_size}")
                for j, p in enumerate(group):
                    p.result = out[j]
            except Exception as e:  # noqa: BLE001 — propagated per-request
                for p in group:
                    p.error = e
            now = time.monotonic()
            with self._lock:
                self.n_requests += n_real
                self.n_batches += 1
                self.n_rows_real += n_real
                self._latencies.extend(now - p.enqueued_at for p in group)
                del self._latencies[:-512]
            batch_index += 1
            for p in group:
                p.done.set()


def make_pipeline_runner(pipeline_fn, seed: int = 0, device="cuda"):
    """Adapt a video pipeline into MicroBatcher's ``run_batch`` contract.

    ``pipeline_fn(masked_frames, audio, identity, class_label, generator)``
    is the ``make_video_pipeline`` signature, on tensors that lie on
    ``device`` (where the model lies). Batch i draws its noise from a
    ``torch.Generator`` on ``device`` seeded with ``batch_seed(seed, i)``, so
    any served frame is reproducible offline from (seed, batch index,
    inputs). The default device is the GPU; pass ``"cpu"`` only on request
    (tests, debugging): nothing here falls back by itself.
    """
    import torch

    device = torch.device(device)

    def run_batch(stacked: Dict[str, np.ndarray], batch_index: int):
        to = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dt)
        gen = torch.Generator(device=device)
        gen.manual_seed(batch_seed(seed, batch_index))
        out = pipeline_fn(
            to(stacked["masked_frames"], torch.float32),
            to(stacked["audio"], torch.float32),
            to(stacked["identity"], torch.float32),
            to(stacked["class_label"], torch.long),
            gen,
        )
        return out.float().cpu().numpy()

    return run_batch


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------

_REQUIRED_FIELDS = ("masked_frames", "audio", "identity", "class_label")


class PipelineServer:
    """stdlib HTTP server wrapping a MicroBatcher.

    `clip_shapes` maps each request field to its REQUIRED per-clip shape
    (no batch axis); mismatches are a 400, not a crash — static-shape tiers
    are part of the serving contract, and the error message says what the
    tier expects.
    """

    def __init__(self, batcher: MicroBatcher,
                 clip_shapes: Dict[str, Tuple[int, ...]],
                 request_timeout_s: float = 600.0,
                 max_body_bytes: int = 1 << 30):
        self.batcher = batcher
        self.clip_shapes = dict(clip_shapes)
        missing = [k for k in _REQUIRED_FIELDS if k not in self.clip_shapes]
        if missing:
            # a server CONFIG bug — fail at construction, not as a per-request
            # KeyError that the 400 net would misattribute to the client
            raise ValueError(
                f"clip_shapes missing required fields {missing}; "
                f"required: {list(_REQUIRED_FIELDS)}")
        self.request_timeout_s = request_timeout_s
        # upper bound on request bodies: without it a single client's declared
        # multi-GB Content-Length is read fully into memory, defeating the
        # max_queue/Overloaded load-shedding design
        self.max_body_bytes = max_body_bytes
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # -- request plumbing ---------------------------------------------------
    def _validate(self, arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        missing = [k for k in _REQUIRED_FIELDS if k not in arrays]
        if missing:
            raise BadRequest(f"missing npz fields: {missing}; "
                             f"required: {list(_REQUIRED_FIELDS)}")
        out = {}
        for k in _REQUIRED_FIELDS:
            a = np.asarray(arrays[k])
            want = self.clip_shapes[k]
            if tuple(a.shape) != tuple(want):
                raise BadRequest(
                    f"field '{k}' has shape {tuple(a.shape)}; this server's "
                    f"tier requires {tuple(want)}")
            out[k] = (a.astype(np.int32) if k == "class_label"
                      else a.astype(np.float32))
        return out

    def handle_synthesize(self, body: bytes) -> bytes:
        try:
            arrays = dict(np.load(io.BytesIO(body), allow_pickle=False))
        except Exception as e:  # zipfile.BadZipFile / OSError / EOFError / …
            # any failure to PARSE the body is the client's malformed upload,
            # not a server fault — normalize to BadRequest so do_POST maps it
            # to 400 instead of 500
            raise BadRequest(f"request body is not a readable npz: {e}")
        inputs = self._validate(arrays)
        frames = self.batcher.submit(inputs, timeout=self.request_timeout_s)
        buf = io.BytesIO()
        np.savez_compressed(buf, frames=np.asarray(frames, np.float32))
        return buf.getvalue()

    def health(self) -> Dict:
        return {
            "status": "ok",
            "tier": {k: list(v) for k, v in self.clip_shapes.items()},
            "batch_size": self.batcher.batch_size,
        }

    # -- lifecycle -----------------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _reply(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, obj):
                self._reply(code, json.dumps(obj).encode(), "application/json")

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply_json(200, server.health())
                elif self.path == "/stats":
                    self._reply_json(200, server.batcher.stats())
                else:
                    self._reply_json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/synthesize":
                    self._reply_json(404, {"error": f"no route {self.path}"})
                    return
                raw_len = self.headers.get("Content-Length", "0")
                try:
                    n = int(raw_len)
                except ValueError:
                    n = -1
                if n < 0 or n > server.max_body_bytes:
                    # reject BEFORE reading: rfile.read(-1) would block until
                    # an EOF that never comes under keep-alive (one leaked
                    # handler thread per request), and an unbounded declared
                    # length would be read fully into memory, defeating the
                    # max_queue/Overloaded load-shedding design. The body was
                    # not consumed, so the connection must close (keep-alive
                    # would misparse the unread body as the next request).
                    self.close_connection = True
                    if n > server.max_body_bytes:
                        self._reply_json(
                            413, {"error": f"body of {n} bytes exceeds the "
                                  f"{server.max_body_bytes}-byte cap"})
                    else:
                        self._reply_json(
                            400,
                            {"error": f"bad Content-Length {raw_len!r}"})
                    return
                try:
                    body = self.rfile.read(n)
                    out = server.handle_synthesize(body)
                except BadRequest as e:
                    # ONLY client faults (parse/validate) — a ValueError out
                    # of run_batch/submit is a server fault and falls through
                    # to the 500 arm below
                    self._reply_json(400, {"error": str(e)})
                except Overloaded as e:
                    self._reply_json(503, {"error": str(e)})
                except TimeoutError as e:
                    self._reply_json(504, {"error": str(e)})
                except Exception as e:  # noqa: BLE001 — surfaced as 500
                    self._reply_json(500, {"error": f"{type(e).__name__}: {e}"})
                else:
                    self._reply(200, out, "application/octet-stream")

        return Handler

    def start(self, host: str = "127.0.0.1", port: int = 8000) -> int:
        """Start serving in a background thread; returns the bound port."""
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="pipeline-http")
        self._thread.start()
        return self._httpd.server_address[1]

    def serve_forever(self, host: str = "0.0.0.0", port: int = 8000):
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        try:
            self._httpd.serve_forever()
        finally:
            self.batcher.shutdown()

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.batcher.shutdown()
