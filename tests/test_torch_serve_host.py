"""The port's serving host (``avsr_tpu_torch/serve_host.py``: dynamic
batching + the HTTP API) on port artifacts, mirroring
``tests/test_serve_host.py``: concurrent requests coalesce into fewer
decode calls than requests and give the direct ``Predictor.transcribe``
texts; oversize requests span several calls; errors are delivered per
request without killing the worker; the HTTP API end to end, n-best
artifacts directly and over HTTP, and client faults answered with 400.
Everything runs on the CPU (``device="cpu"``).
"""

import base64
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from avsr_tpu_torch.serve import Predictor, export_serving_artifact
from avsr_tpu_torch.serve_host import DynamicBatcher, make_server
from test_torch_serve_artifact import data, tiny_avsr  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory, data):  # noqa: F811
    tmp = tmp_path_factory.mktemp("serve_host")
    avsr = tiny_avsr(tmp / "run", data)
    avsr.train(num_epochs=1)
    out = export_serving_artifact(avsr, str(tmp / "artifact"), use_beam=False, batch_size=4,
                                  audio_seconds=0.5)
    nbest = export_serving_artifact(avsr, str(tmp / "artifact_nbest"), use_beam=True,
                                    batch_size=4, audio_seconds=0.5, n_best=3)
    return out, [u.waveform for u in data[:4]], nbest


def load(path):
    return Predictor.load(path, device="cpu")


def serve(path, **kw):
    return make_server(path, port=0, device="cpu", **kw)


def _post(port, payload, path="/v1/transcribe"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_batcher_coalesces_and_matches_direct(artifact):
    path, wavs, _ = artifact
    pred = load(path)
    want = pred.transcribe(audio=wavs)

    batcher = DynamicBatcher(pred, max_wait_ms=300.0)
    try:
        results = [None] * 4

        def client(i):
            results[i] = batcher.submit_many(audio=[wavs[i]])[0]

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert results == want
        # 4 single-utterance clients within the wait window -> fewer
        # decode calls than requests (usually exactly 1)
        assert batcher.stats["batches"] < batcher.stats["requests"]
        assert batcher.stats["utterances"] == 4
    finally:
        batcher.close()


def test_batcher_spans_oversize_requests(artifact):
    path, wavs, _ = artifact
    batcher = DynamicBatcher(load(path), max_wait_ms=1.0)
    try:
        # 6 utterances > max_batch 4: spans two decode calls transparently
        texts = batcher.submit_many(audio=[wavs[i % 4] for i in range(6)])
        assert len(texts) == 6
        assert texts[0] == texts[4]
        assert batcher.stats["batches"] >= 2
    finally:
        batcher.close()


def test_batcher_delivers_errors_and_keeps_serving(artifact):
    path, wavs, _ = artifact
    batcher = DynamicBatcher(load(path), max_wait_ms=1.0)
    try:
        # out-of-range audio is rejected at SUBMIT time, per utterance —
        # before it can coalesce with (and fail) other clients' requests
        with pytest.raises(ValueError, match="utterance 1"):
            batcher.submit_many(
                audio=[wavs[0], np.full(800, 2.5, np.float32)]
            )
        # the worker survives and serves the next request
        assert batcher.submit_many(audio=[wavs[0]])
    finally:
        batcher.close()


def test_http_server_end_to_end(artifact):
    path, wavs, _ = artifact
    server, batcher = serve(path, max_wait_ms=100.0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        status, health = _post_get(port, "/healthz")
        assert status == 200 and health == {"ok": True}

        want = load(path).transcribe(audio=wavs[:2])
        # one request with plain float lists, one with compact-wire b64
        i16 = np.clip(np.round(wavs[1] * 32767.0), -32768, 32767).astype(
            np.int16)
        status, resp = _post(port, {"audio": [
            wavs[0].tolist(),
            {"b64": base64.b64encode(i16.tobytes()).decode(),
             "dtype": "int16"},
        ]})
        assert status == 200
        assert resp["texts"] == want

        status, resp = _post(port, {"nonsense": 1})
        assert status == 400 and "error" in resp

        status, stats = _post_get(port, "/stats")
        assert status == 200 and stats["utterances"] >= 2
    finally:
        server.shutdown()
        batcher.close()


def test_nbest_artifact_direct_and_http(artifact):
    """An --n-best artifact: transcribe() still returns top-1 (== rank 0 of
    transcribe_nbest, scores non-increasing); the HTTP host returns ranked
    alternatives on request and 400s n_best against a top-1 artifact."""
    top1_path, wavs, nbest_path = artifact
    pred = load(nbest_path)
    assert pred.n_best == 3
    texts = pred.transcribe(audio=wavs)
    alts = pred.transcribe_nbest(audio=wavs)
    for t, a in zip(texts, alts):
        assert len(a) == 3
        assert a[0][0] == t
        scores = [s for _, s in a]
        assert scores == sorted(scores, reverse=True)

    server, batcher = serve(nbest_path, max_wait_ms=1.0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, resp = _post(port, {"audio": [wavs[0].tolist()],
                                    "n_best": 2})
        assert status == 200
        assert resp["texts"] == texts[:1]
        assert len(resp["alternatives"][0]) == 2
        assert resp["alternatives"][0][0][0] == texts[0]
    finally:
        server.shutdown()
        batcher.close()

    # n_best request against a top-1 artifact fails loudly
    server, batcher = serve(top1_path, max_wait_ms=1.0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, resp = _post(port, {"audio": [wavs[0].tolist()],
                                    "n_best": 2})
        assert status == 400
        assert "top-1" in resp["error"] or "n-best" in resp["error"].lower()
    finally:
        server.shutdown()
        batcher.close()


def test_http_client_errors_are_400(artifact):
    """Client-input faults (bad n_best, wrong modality, out-of-range
    audio) answer 400, not 500 or a dropped connection."""
    path, wavs, _ = artifact
    server, batcher = serve(path, max_wait_ms=1.0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        status, resp = _post(port, {"audio": [wavs[0].tolist()],
                                    "n_best": "two"})
        assert status == 400 and "error" in resp
        status, resp = _post(port, {"video": [[0.0] * 8]})  # audio artifact
        assert status == 400 and "modalit" in resp["error"]
        status, resp = _post(port, {"audio": [[2.5] * 800]})  # out of range
        assert status == 400 and "error" in resp
        # the worker still serves valid requests afterwards
        status, resp = _post(port, {"audio": [wavs[0].tolist()]})
        assert status == 200
    finally:
        server.shutdown()
        batcher.close()


def _post_get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30
    ) as r:
        return r.status, json.loads(r.read())
