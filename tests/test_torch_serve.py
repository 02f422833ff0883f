"""PyTorch port, the serving surface: the port's ``serve.make_handler``
over a live ``serve.ServingHTTPServer`` on 127.0.0.1 with
``Predictor(device="cpu")`` (the stock CAM++ with seeded weights, on the
kernel path), the ``MicroBatcher``, and the command-line modules. The
cases follow ``tests/test_serve.py``: every endpoint, the traversal probes
(400), the per-request threshold, micro-batched embeddings equal to
per-request ones (atol 1e-4 on the plain path, cos > 0.9999 on the
kernel path) with fewer device batches than requests, one
``predict_batch`` call for a window of more than 32 clips, and an
exception reaching every waiter. Random weights embed every clip at
cos ~1 to every other, so a recognised name is held against the same
predictor called in this process, not against the speaker who spoke."""

import io
import json
import os
import shutil
import threading
import urllib.error
import urllib.parse
import urllib.request
import wave as wave_mod

import numpy as np
import pytest
import torch
import yaml

from test_torch_helpers import FULL, SMALL, cos_min, synth_campplus, tone
from voiceprintrecognition_paddlepaddle_torch import (infer_contrast,
                                                      infer_speaker_diarization,
                                                      serve)
from voiceprintrecognition_paddlepaddle_torch.infer_utils.micro_batcher \
    import MicroBatcher
from voiceprintrecognition_paddlepaddle_torch.predict import Predictor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000


def _wav_bytes(samples):
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _body(freq, seconds=1.0, seed=0):
    return _wav_bytes(tone(freq, seconds, seed))


def _configs():
    with open(os.path.join(ROOT, "configs", "cam++.yml"), encoding="utf-8") as f:
        cfg = yaml.safe_load(f)
    return {k: cfg[k] for k in ("dataset_conf", "preprocess_conf",
                                "model_conf")}


def _start(handler):
    httpd = serve.ServingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def _stop(httpd):
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    _, _, tm = synth_campplus(FULL, seed=3)
    root = tmp_path_factory.mktemp("serve")
    torch.save(tm.state_dict(), str(root / "model.pt"))
    return root, str(root / "model.pt")


@pytest.fixture(scope="module")
def stack(model):
    root, model_path = model
    db = str(root / "db")
    shutil.copytree(os.path.join(ROOT, "audio_db"), db,
                    ignore=shutil.ignore_patterns("audio_indexes.bin"))
    pred = Predictor(_configs(), model_path=model_path, audio_db_path=db,
                     threshold=0.1, device="cpu")
    httpd, url = _start(serve.make_handler(pred))
    yield url, pred
    _stop(httpd)


@pytest.fixture(scope="module")
def server(stack):
    return stack[0]


@pytest.fixture(scope="module")
def batched_server(stack):
    """The same predictor behind a second server with micro-batching (a
    generous 150 ms window so that thread scheduling aggregates)."""
    _, pred = stack
    batcher = MicroBatcher(pred, window_ms=150.0, max_batch=32)
    httpd, url = _start(serve.make_handler(pred, batcher))
    yield url, batcher
    _stop(httpd)


def _post(url, body=b""):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _expect(code, url, body=b""):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, body)
    assert e.value.code == code
    out = json.loads(e.value.read())
    assert "error" in out
    return out


def test_embedding_endpoint(server, stack):
    _, pred = stack
    body = _body(120)
    emb = np.asarray(_post(f"{server}/embedding", body)["embedding"])
    assert emb.shape == (192,) and np.isfinite(emb).all()
    want = pred.predict_batch([pred._load_audio(body).samples])[0]
    np.testing.assert_allclose(emb, want, atol=1e-5)


def _in_process(stack, body, threshold=None):
    """What the server's predictor answers for ``body`` when called here,
    on the server's path (``_load_audio``, then ``predict_batch``)."""
    _, pred = stack
    emb = pred.predict_batch([pred._load_audio(body).samples])[0]
    return pred.retrieve(emb[None], threshold=threshold)[0]


def test_register_recognise_users(server, stack):
    assert _post(f"{server}/register?name=alice", _body(120, seed=1))["success"]
    assert _post(f"{server}/register?name=bob", _wav_bytes(
        (np.random.RandomState(2).randn(SR) * 0.1).astype(np.float32)))[
        "success"]
    users = _get(f"{server}/users")["users"]
    assert {"alice", "bob", "user_a", "user_b"} <= set(users)
    out = _post(f"{server}/recognition", _body(120, seed=1))
    assert [out["name"], out["score"]] == _in_process(stack, _body(120, seed=1))


def test_bad_audio_is_a_json_400(server):
    _expect(400, f"{server}/recognition", b"not a wav")
    # a RIFF header whose fmt chunk is cut short
    _expect(400, f"{server}/embedding",
            b"RIFF\x10\x00\x00\x00WAVEfmt \x04\x00\x00\x00\x01\x00\x01\x00")
    _expect(400, f"{server}/embedding", b"")
    _expect(400, f"{server}/contrast", _body(120))          # no 'other'
    _expect(400, f"{server}/diarization?speakers=two", _body(120))


@pytest.mark.parametrize("bad", ["../evil", "a/b", "..", ".hidden", "a\\b",
                                 ""])
def test_register_rejects_path_traversal(server, stack, bad):
    _, pred = stack
    q = urllib.parse.quote(bad, safe="")
    _expect(400, f"{server}/register?name={q}", _body(120))
    assert not os.path.exists(os.path.join(pred.audio_db_path, "..", "evil"))


def test_contrast_is_restricted_to_audio_db(server):
    score = _post(f"{server}/contrast?other=user_a/0.wav", _body(205))["score"]
    assert -1.0 <= score <= 1.0
    for bad in ("../../etc/passwd", "/etc/passwd", "user_a/missing.wav"):
        q = urllib.parse.quote(bad, safe="")
        _expect(400, f"{server}/contrast?other={q}", _body(205))


def test_diarization_endpoint(server):
    scene = np.concatenate([tone(150, 5.0, 1), np.zeros(SR, np.float32),
                            (np.random.RandomState(0).randn(6 * SR) * 0.1)
                            .astype(np.float32)])
    body = _wav_bytes(scene)
    segs = _post(f"{server}/diarization", body)["segments"]
    assert segs and all(set(s) == {"speaker", "start", "end"} for s in segs)
    assert all(s["end"] > s["start"] for s in segs)
    named = _post(f"{server}/diarization?speakers=2&search_db=1&threshold=0",
                  body)["segments"]
    assert len({s["speaker"] for s in named}) <= 2
    assert all(isinstance(s["speaker"], str) for s in named)


def test_requests_run_on_long_lived_threads():
    """Serial requests reuse one worker thread and concurrent ones at most
    ``workers`` threads (a new thread per request paid for a new cuDNN
    handle on the card every time)."""
    from http.server import BaseHTTPRequestHandler

    class Ident(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(threading.get_ident()).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    three = type("ThreeWorkers", (serve.ServingHTTPServer,), {"workers": 3})
    httpd = three(("127.0.0.1", 0), Ident)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/"
    try:
        serial = {_get(url) for _ in range(10)}
        seen = []
        threads = [threading.Thread(target=lambda: seen.append(_get(url)))
                   for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        _stop(httpd)
    assert len(serial) == 1
    assert len(seen) == 12 and len(set(seen)) <= 3


def test_a_serial_client_keeps_its_thread_while_the_answer_winds_up():
    """The thread that answered takes the client's next request even when
    it is still winding up after the answer, for longer than
    ``spawn_after_s`` (here 50 ms after each handler returns): a thread
    counts as free for the next request once its handler starts the final
    response, however late the host schedules it afterwards."""
    import time
    from http.server import BaseHTTPRequestHandler

    class Ident(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(threading.get_ident()).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    def finish_request(self, request, client_address):
        serve.ServingHTTPServer.finish_request(self, request, client_address)
        time.sleep(0.05)

    lingering = type("Lingering", (serve.ServingHTTPServer,), {
        "workers": 3, "finish_request": finish_request})
    assert lingering.spawn_after_s < 0.05
    httpd = lingering(("127.0.0.1", 0), Ident)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/"
    try:
        serial = [_get(url) for _ in range(10)]
    finally:
        _stop(httpd)
    assert len(set(serial)) == 1


def test_hand_overs_lose_no_request_under_contention():
    """Sixteen clients (more than the host's cores) each send six serial
    requests to a four-worker server whose threads wind up 5 ms after
    each answer, with a short switch interval: every request is answered
    (a request left to an answering thread and then dropped would time
    out) and at most four threads serve them."""
    import sys
    import time
    from http.server import BaseHTTPRequestHandler

    class Ident(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(threading.get_ident()).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    def finish_request(self, request, client_address):
        serve.ServingHTTPServer.finish_request(self, request, client_address)
        time.sleep(0.005)

    lingering = type("Lingering", (serve.ServingHTTPServer,), {
        "workers": 4, "finish_request": finish_request})
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    httpd = lingering(("127.0.0.1", 0), Ident)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/"
    seen = []
    try:
        clients = [threading.Thread(
            target=lambda: seen.extend(_get(url) for _ in range(6)))
            for _ in range(16)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=60)
        assert not any(c.is_alive() for c in clients)
    finally:
        sys.setswitchinterval(interval)
        _stop(httpd)
    assert len(seen) == 96 and len(set(seen)) <= 4


def test_an_answer_that_stalls_holds_up_the_next_client_briefly():
    """A handler that stalls after ``end_headers`` (as a write to a client
    that stops reading does) keeps its thread, and the next client's
    request gets a new thread within ``handover_s`` instead of waiting
    for the stalled answer."""
    import time
    from http.server import BaseHTTPRequestHandler

    stalling, release = threading.Event(), threading.Event()

    class Stall(BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(threading.get_ident()).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            if self.path == "/stall":
                stalling.set()
                release.wait(timeout=10)
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    two = type("TwoWorkers", (serve.ServingHTTPServer,), {"workers": 2})
    httpd = two(("127.0.0.1", 0), Stall)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/"
    stalled = []
    try:
        first = threading.Thread(
            target=lambda: stalled.append(_get(url + "stall")))
        first.start()
        assert stalling.wait(timeout=10)
        t0 = time.monotonic()
        other = _get(url)
        waited = time.monotonic() - t0
        release.set()
        first.join(timeout=30)
        assert not first.is_alive()
    finally:
        release.set()
        _stop(httpd)
    assert waited < 2.0  # handover_s (0.25 s), well short of the stall
    assert other != stalled[0]


def test_requests_that_wait_on_each_other_each_get_a_thread():
    """Concurrent requests that wait on one another (as micro-batched ones
    wait for their batch) grow the pool: eight handlers meet at a barrier
    of eight, which needs eight threads at once."""
    from http.server import BaseHTTPRequestHandler

    barrier = threading.Barrier(8, timeout=30)

    class Meet(BaseHTTPRequestHandler):
        def do_GET(self):
            barrier.wait()
            body = json.dumps(threading.get_ident()).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    eight = type("EightWorkers", (serve.ServingHTTPServer,), {"workers": 8})
    httpd = eight(("127.0.0.1", 0), Meet)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/"
    try:
        seen = []
        threads = [threading.Thread(target=lambda: seen.append(_get(url)))
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        _stop(httpd)
    assert len(seen) == 8 and len(set(seen)) == 8


def test_stats_and_unknown_endpoints(server):
    assert _get(f"{server}/stats") == {"batches": 0, "items": 0}
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{server}/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(f"{server}/nope", _body(120))
    assert e.value.code == 404


def test_recognition_threshold_is_per_request(server, stack):
    """A threshold query parameter must not leak into the shared
    predictor, and threshold=0 (accept the best match) is honoured."""
    _, pred = stack
    body = _body(130, seed=5)
    _post(f"{server}/register?name=dana", body)
    before = pred.threshold
    assert _post(f"{server}/recognition?threshold=1.01", body)["name"] is None
    assert pred.threshold == before
    out = _post(f"{server}/recognition", body)
    assert [out["name"], out["score"]] == _in_process(stack, body)
    assert out["name"] is not None and out["score"] > 0.999
    assert _post(f"{server}/recognition?threshold=0",
                 _body(500, seed=9))["name"] is not None


def _concurrent_embeddings(url, bodies):
    results = [None] * len(bodies)
    errors = []

    def hit(i):
        try:
            results[i] = np.asarray(
                _post(f"{url}/embedding", bodies[i])["embedding"])
        except Exception as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=hit, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


@pytest.fixture(scope="module")
def narrow_servers(tmp_path_factory):
    """A CAM++ at ``init_channels: 32``: the plain fp32 model, whose
    embedding of a clip does not move with the batch it rides in. (The
    kernel path's plain version rounds to bf16 where the kernel does, so on
    the CPU its results move with the matmul blocking of the batch size, by
    up to 3e-3 here.)"""
    _, _, tm = synth_campplus(SMALL, seed=4)
    root = tmp_path_factory.mktemp("narrow_serve")
    torch.save(tm.state_dict(), str(root / "model.pt"))
    cfg = _configs()
    cfg["model_conf"] = dict(cfg["model_conf"], model_args=dict(SMALL))
    pred = Predictor(cfg, model_path=str(root / "model.pt"), device="cpu")
    batcher = MicroBatcher(pred, window_ms=150.0, max_batch=32)
    (solo, url), (batched, burl) = (_start(serve.make_handler(pred)),
                                    _start(serve.make_handler(pred, batcher)))
    yield url, burl, batcher
    _stop(solo)
    _stop(batched)


def test_dynamic_batching_matches_unbatched(narrow_servers):
    url, burl, batcher = narrow_servers
    bodies = [_body(110 + 25 * i, seed=40 + i) for i in range(10)]
    solo = [np.asarray(_post(f"{url}/embedding", b)["embedding"])
            for b in bodies]
    for got, want in zip(_concurrent_embeddings(burl, bodies), solo):
        np.testing.assert_allclose(got, want, atol=1e-4)
    assert batcher.items >= len(bodies)
    assert batcher.batches < batcher.items
    assert _get(f"{burl}/stats") == {"batches": batcher.batches,
                                     "items": batcher.items}


def test_dynamic_batching_on_the_kernel_path(server, batched_server):
    burl, batcher = batched_server
    bodies = [_body(110 + 25 * i, seed=40 + i) for i in range(10)]
    solo = np.stack([_post(f"{server}/embedding", b)["embedding"]
                     for b in bodies])
    got = np.stack(_concurrent_embeddings(burl, bodies))
    assert cos_min(solo, got) > 0.9999
    assert batcher.batches < batcher.items


def test_batched_contrast_and_recognition(batched_server, stack):
    burl, _ = batched_server
    assert _post(f"{burl}/register?name=carol", _body(205, seed=77))["success"]
    out = _post(f"{burl}/recognition", _body(205, seed=77))
    want = _in_process(stack, _body(205, seed=77))
    assert out["name"] == want[0] and abs(out["score"] - want[1]) < 1e-4
    score = _post(f"{burl}/contrast?other=carol/0.wav",
                  _body(205, seed=77))["score"]
    assert score > 0.99


def test_microbatcher_dispatches_one_device_batch_above_32(stack):
    """A window larger than predict_batch's default batch_size (32) must
    reach the predictor as ONE call covering the whole window."""
    _, pred = stack
    calls = []
    real = pred.predict_batch

    def spy(audios, **kw):
        calls.append((len(audios), kw.get("batch_size")))
        return real(audios, **kw)

    pred.predict_batch = spy
    try:
        batcher = MicroBatcher(pred, window_ms=300.0, max_batch=40)
        futs = [batcher.embed_async(
            np.random.RandomState(i).randn(SR).astype(np.float32) * 0.1)
            for i in range(36)]
        embs = [f.result(timeout=120) for f in futs]
    finally:
        del pred.predict_batch
    assert all(e.shape == (192,) for e in embs)
    assert calls and all(bs == 40 for _, bs in calls)
    assert max(n for n, _ in calls) > 32


class _Failing:
    """A predictor whose embed raises, for the error paths."""

    def __init__(self):
        self.calls = 0

    def predict_batch(self, audios, batch_size=32):
        self.calls += 1
        raise RuntimeError("kernel launch failed")

    def _load_audio(self, audio):
        from voiceprintrecognition_paddlepaddle_torch.ops.audio import \
            AudioSegment
        return AudioSegment.from_bytes(audio)

    def predict(self, seg):
        return self.predict_batch([seg.samples])[0]


def test_batcher_exception_reaches_every_waiter():
    failing = _Failing()
    batcher = MicroBatcher(failing, window_ms=200.0, max_batch=8)
    futs = [batcher.embed_async(np.zeros(SR, np.float32)) for _ in range(5)]
    for f in futs:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            f.result(timeout=60)
    assert failing.calls >= 1 and batcher.batches == 0
    # the batcher thread keeps serving after a failed batch
    late = batcher.embed_async(np.zeros(SR, np.float32))
    with pytest.raises(RuntimeError):
        late.result(timeout=60)


@pytest.mark.parametrize("batched", [False, True])
def test_server_fault_answers_500_and_keeps_serving(batched):
    failing = _Failing()
    batcher = MicroBatcher(failing, window_ms=5.0) if batched else None
    httpd, url = _start(serve.make_handler(failing, batcher))
    try:
        for _ in range(2):
            out = _expect(500, f"{url}/embedding", _body(120))
            assert "kernel launch failed" in out["error"]
        _expect(400, f"{url}/embedding", b"not a wav")
    finally:
        _stop(httpd)


def test_command_line_modules(model, tmp_path, capsys):
    _, model_path = model
    cfg = tmp_path / "cam++.yml"
    cfg.write_text(yaml.safe_dump(_configs()), encoding="utf-8")
    a = os.path.join(ROOT, "dataset", "a_1.wav")
    score = infer_contrast.main([f"--configs={cfg}", "--device=cpu",
                                 f"--model_path={model_path}",
                                 f"--audio_path1={a}", f"--audio_path2={a}"])
    assert score > 0.999
    assert "SAME speaker" in capsys.readouterr().out
    db = tmp_path / "db"
    shutil.copytree(os.path.join(ROOT, "audio_db"), db,
                    ignore=shutil.ignore_patterns("audio_indexes.bin"))
    out = infer_speaker_diarization.main([
        f"--configs={cfg}", "--device=cpu", f"--model_path={model_path}",
        f"--audio_path={os.path.join(ROOT, 'dataset', 'test_long.wav')}",
        f"--audio_db_path={db}", "--search_audio_db=True", "--threshold=0",
        "--speaker_num=2"])
    assert out and all(isinstance(s["speaker"], str) for s in out)
    assert "diarization results:" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--help"])
    assert "--data_parallel" in capsys.readouterr().out
