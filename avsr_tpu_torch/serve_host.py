"""Serving host: dynamic request batching + HTTP front for artifacts
(counterpart of ``avsr_tpu/serve_host.py``, numpy and the standard library
around the port's ``load_predictor``).

- **One device-consumer thread.**  A single worker draining a queue runs
  every decode on the card (its current stream is the default stream, and
  ``kernels.BeamStep`` binds one search at a time), gives back-pressure for
  free and keeps the device fed instead of lock-convoyed.
- **Dynamic batching.**  Requests arriving within ``max_wait_ms`` of each
  other are padded into ONE decode call: a request's host dispatch and
  transfer are paid once a batch, not once an utterance.
- **Static shapes.**  The artifact's (bucketed) predictors do the shape
  routing; the batcher only caps group size at the artifact's batch
  capacity.

HTTP API (stdlib ThreadingHTTPServer; each connection thread parks in the
batcher while the worker fills a batch):

    POST /v1/transcribe   {"audio": [utt, ...], "video": [utt, ...],
                           "n_best": K?}
        utt = [float, ...] (nested lists for video), or a compact-wire
        object {"b64": <base64>, "dtype": "int16"|"uint8"|"float32",
        "shape": [...]} (int16 PCM -> /32767, uint8 pixels -> /255).
        -> {"texts": [str, ...]} (+ "alternatives": [[(text, score)...]...]
        when n_best > 1 and the artifact was exported with --n-best)
    GET  /healthz         -> {"ok": true}
    GET  /stats           -> {"requests": N, "batches": M, ...}

CLI: ``python -m avsr_tpu_torch.cli serve --artifact DIR --port 8000``
(``--device cpu`` serves on the CPU).
"""

from __future__ import annotations

import base64
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np


class _Pending:
    __slots__ = ("audio", "video", "event", "text", "alts", "error")

    def __init__(self, audio, video):
        self.audio = audio
        self.video = video
        self.event = threading.Event()
        self.text: Optional[str] = None
        self.alts = None  # [(text, score), ...] for n-best artifacts
        self.error: Optional[Exception] = None


class DynamicBatcher:
    """Coalesce concurrent transcription requests into batched decodes.

    ``max_batch`` defaults to the artifact's (smallest bucket's) exported
    batch size; ``max_wait_ms`` bounds the extra latency the first request
    in a batch pays waiting for company.
    """

    def __init__(self, predictor, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0):
        self._pred = predictor
        cap = getattr(predictor, "batch_size", None)
        if cap is None:  # BucketedPredictor: every bucket must fit the group
            cap = min(p.batch_size for p in predictor.buckets)
        self.max_batch = min(max_batch, cap) if max_batch else cap
        # The artifact's required modalities: validated per request at
        # submit time, so every queued request has the SAME modality
        # signature and any coalesced batch is well-formed.
        meta = predictor.meta
        if "buckets" in meta:
            meta = predictor.buckets[0].meta
        self._required = {i["name"] for i in meta["inputs"]
                          if i["name"] in ("audio", "video")}
        self._max_wait = max_wait_ms / 1e3
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "utterances": 0}
        self._worker = threading.Thread(
            target=self._run, name="avsr-batcher", daemon=True
        )
        self._worker.start()

    # -- client side -----------------------------------------------------

    def submit_many(self, audio=None, video=None, timeout: float = 120.0,
                    return_alternatives: bool = False):
        """Submit N utterances (blocking); each may batch with OTHER
        clients' utterances — a request larger than max_batch just spans
        several decode calls.  ``return_alternatives`` additionally returns
        each utterance's ranked [(text, score), ...] list (n-best
        artifacts; None per utterance otherwise)."""
        got = {name for name, v in (("audio", audio), ("video", video))
               if v is not None}
        if got != self._required:
            raise ValueError(
                f"artifact requires modalities {sorted(self._required)}, "
                f"request carries {sorted(got) or 'none'}"
            )
        n = len(audio) if audio is not None else len(video)
        if n == 0:
            raise ValueError("empty request: no utterances")
        # Per-utterance validation BEFORE enqueueing (horizon, trailing
        # shape, quantize range): a bad utterance must fail ITS OWN
        # request — once coalesced, the whole device batch would fail for
        # every client in it.
        rows = []
        validate = getattr(self._pred, "validate_utterance", None)
        for i in range(n):
            a = None if audio is None else np.asarray(audio[i], np.float32)
            v = None if video is None else np.asarray(video[i], np.float32)
            if validate is not None:
                try:
                    validate(audio=a, video=v)
                except ValueError as e:
                    raise ValueError(f"utterance {i}: {e}") from e
            rows.append((a, v))
        pendings = []
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is closed")
            for a, v in rows:
                p = _Pending(a, v)
                self._queue.append(p)
                pendings.append(p)
            self.stats["requests"] += 1
            self._cond.notify_all()
        deadline = time.monotonic() + timeout
        for p in pendings:
            if not p.event.wait(max(deadline - time.monotonic(), 0.0)):
                # shed this request's still-queued work so an abandoned
                # client doesn't keep consuming decode batches (in-flight
                # entries finish wastefully once, then are dropped)
                with self._cond:
                    for q in pendings:
                        try:
                            self._queue.remove(q)
                        except ValueError:
                            pass
                raise TimeoutError("transcription timed out")
            if p.error is not None:
                raise p.error
        if return_alternatives:
            return [p.text for p in pendings], [p.alts for p in pendings]
        return [p.text for p in pendings]

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._worker.join(timeout=5.0)

    # -- device side -----------------------------------------------------

    def _take_batch(self) -> List[_Pending]:
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait()
            if not self._queue:
                return []
            batch = [self._queue.popleft()]
            deadline = time.monotonic() + self._max_wait
            while len(batch) < self.max_batch and not self._closed:
                if self._queue:
                    batch.append(self._queue.popleft())
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            return batch

    def _run(self):
        while True:
            batch = self._take_batch()
            if not batch:
                return  # closed and drained
            try:
                kwargs: Dict[str, Any] = {}
                if batch[0].audio is not None:
                    kwargs["audio"] = [p.audio for p in batch]
                if batch[0].video is not None:
                    kwargs["video"] = [p.video for p in batch]
                if int(getattr(self._pred, "n_best", 1)) > 1:
                    alts = self._pred.transcribe_nbest(**kwargs)
                    for p, a in zip(batch, alts):
                        p.alts = a
                        p.text = a[0][0]
                else:
                    texts = self._pred.transcribe(**kwargs)
                    for p, t in zip(batch, texts):
                        p.text = t
            except Exception as e:  # deliver to every waiter, keep serving
                for p in batch:
                    p.error = e
            finally:
                self.stats["batches"] += 1
                self.stats["utterances"] += len(batch)
                for p in batch:
                    p.event.set()


def _decode_utterance(utt) -> np.ndarray:
    """JSON utterance -> float32 array (compact-wire b64 or plain lists)."""
    if isinstance(utt, dict):
        dtype = utt.get("dtype", "float32")
        raw = np.frombuffer(base64.b64decode(utt["b64"]), dtype=dtype)
        if "shape" in utt:
            raw = raw.reshape(utt["shape"])
        if dtype == "int16":
            return (raw.astype(np.float32) / 32767.0)
        if dtype == "uint8":
            return raw.astype(np.float32) / 255.0
        return raw.astype(np.float32)
    return np.asarray(utt, dtype=np.float32)


class _Handler(BaseHTTPRequestHandler):
    batcher: DynamicBatcher = None  # set by make_server
    # request bodies beyond this are rejected before being read into memory
    # (a 10 s 16 kHz float JSON utterance is ~2 MB; video ROIs dominate)
    max_body_bytes: int = 256 * 1024 * 1024

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json(self, code: int, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            return self._json(200, {"ok": True})
        if self.path == "/stats":
            return self._json(200, dict(self.batcher.stats,
                                        max_batch=self.batcher.max_batch))
        return self._json(404, {"error": "not found"})

    def do_POST(self):
        if self.path != "/v1/transcribe":
            return self._json(404, {"error": "not found"})
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n > self.max_body_bytes:
                return self._json(413, {
                    "error": f"request body {n} bytes exceeds "
                             f"{self.max_body_bytes}"})
            req = json.loads(self.rfile.read(n))
            audio = req.get("audio")
            video = req.get("video")
            if audio is None and video is None:
                raise ValueError("request needs 'audio' and/or 'video'")
            audio = None if audio is None else [
                _decode_utterance(u) for u in audio]
            video = None if video is None else [
                _decode_utterance(u) for u in video]
            if audio is not None and video is not None \
                    and len(audio) != len(video):
                raise ValueError("audio/video utterance counts differ")
            want_n = int(req.get("n_best", 1) or 1)
        except Exception as e:
            return self._json(400, {"error": f"bad request: {e}"})
        try:
            if want_n > 1:
                texts, alts = self.batcher.submit_many(
                    audio=audio, video=video, return_alternatives=True
                )
                if any(a is None for a in alts):
                    return self._json(400, {
                        "error": "artifact was exported top-1 only; "
                                 "re-export with --n-best N"})
                return self._json(200, {
                    "texts": texts,
                    "alternatives": [a[:want_n] for a in alts],
                })
            texts = self.batcher.submit_many(audio=audio, video=video)
            return self._json(200, {"texts": texts})
        except ValueError as e:
            # client-input errors surfaced by the batcher/Predictor
            # (modality mismatch, quantize range, horizon/batch overrun)
            return self._json(400, {"error": str(e)})
        except Exception as e:
            return self._json(500, {"error": str(e)})


def make_server(artifact_dir: str, host: str = "127.0.0.1", port: int = 8000,
                max_batch: Optional[int] = None, max_wait_ms: float = 5.0, device="cuda"):
    """Load an artifact onto ``device`` and return (ThreadingHTTPServer,
    DynamicBatcher).

    Caller runs ``server.serve_forever()``; ``server.server_address[1]``
    is the bound port (pass port=0 for an ephemeral one).
    """
    from avsr_tpu_torch.serve import load_predictor

    predictor = load_predictor(artifact_dir, device=device)
    batcher = DynamicBatcher(predictor, max_batch=max_batch,
                             max_wait_ms=max_wait_ms)
    handler = type("Handler", (_Handler,), {"batcher": batcher})
    server = ThreadingHTTPServer((host, port), handler)
    return server, batcher
