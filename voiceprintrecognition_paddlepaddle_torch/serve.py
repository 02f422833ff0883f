"""HTTP serving front end over the port's Predictor (counterpart of the
JAX package's ``tools/serve.py``).

Endpoints (JSON responses; audio is raw WAV bytes in the request body):

    POST /embedding                 -> {"embedding": [...]}
    POST /contrast?other=<path>     -> {"score": s}     (body vs db file)
    POST /register?name=<user>      -> {"success": true}
    POST /recognition[?threshold=t] -> {"name": ..., "score": ...}
    GET  /users                     -> {"users": [...]}
    GET  /stats                     -> {"batches": n, "items": n}
    POST /diarization[?speakers=n&search_db=1&threshold=t]
                                    -> {"segments": [...]}

stdlib only (``ServingHTTPServer``: a ``ThreadingHTTPServer`` whose
requests run on a pool of long-lived threads). With ``--dynamic_batch_ms``
the embeddings of concurrent requests go through one ``MicroBatcher``
thread as one device batch. Database
writes and diarization hold one lock. A bad request (unreadable audio,
a missing or malformed parameter) answers 400; any other failure, a
kernel fault included, answers 500 and is logged with its traceback.

Run: python -m voiceprintrecognition_paddlepaddle_torch.serve
--configs=configs/cam++.yml --model_path=<model.pt> [--device=cuda]
[--port=8000]. ``--configs`` takes a YAML path and needs PyYAML; code
that has no PyYAML builds ``make_handler(Predictor(<dict>, ...))`` in its
own process. ``--data_parallel`` splits each embedding batch over every
visible CUDA device (``Predictor(data_parallel=True)``), as the JAX
``tools/serve.py --data_parallel``.
"""

import argparse
import collections
import functools
import json
import os
import queue
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .infer_utils.micro_batcher import MicroBatcher
from .predict import Predictor
from .utils.logger import logger
from .utils.utils import add_arguments, print_arguments

__all__ = ["make_handler", "ServingHTTPServer", "main"]

_db_lock = threading.Lock()
# what a malformed request raises on its way through the handler (a WAV
# header cut short reaches the IEEE-float parser's struct.unpack)
_CLIENT_ERRORS = (ValueError, KeyError, struct.error)


def _safe_user_name(name):
    """Reject names that could escape the audio_db directory (path
    traversal through ``os.path.join(audio_db_path, name)``). Unicode
    names (e.g. Chinese) stay allowed."""
    if not name or len(name) > 128:
        return False
    if any(c in name for c in ("/", "\\", "\x00")) or ".." in name:
        return False
    return not name.startswith(".")


def _safe_db_file(path, audio_db_path):
    """Only allow /contrast 'other' to reference files under audio_db."""
    root = os.path.realpath(audio_db_path)
    target = os.path.realpath(os.path.join(root, path))
    return target if os.path.commonpath([root, target]) == root else None


def make_handler(predictor, batcher=None):
    """``batcher`` (a ``MicroBatcher``) aggregates concurrent embed
    requests into single device batches; ``None`` embeds per request."""

    def _embed_many(audios):
        # loaded (resampled, normalised) once; both branches embed the
        # same samples
        samples = [predictor._load_audio(a).samples for a in audios]
        if batcher is None:
            return [predictor.predict_batch([s])[0] for s in samples]
        futures = [batcher.embed_async(s) for s in samples]
        return [f.result() for f in futures]

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, payload):
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return self.rfile.read(n)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/users":
                self._send(200, {"users": predictor.get_users()})
            elif path == "/stats":
                self._send(200, {
                    "batches": getattr(batcher, "batches", 0),
                    "items": getattr(batcher, "items", 0)})
            else:
                self._send(404, {"error": "unknown endpoint"})

        def do_POST(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            try:
                self._post(url.path, q, self._body())
            except _CLIENT_ERRORS as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # a server fault: report it, keep serving
                logger.exception(f"POST {url.path} failed")
                self._send(500, {"error": repr(e)})

        def _post(self, path, q, audio):
            if path == "/embedding":
                emb = _embed_many([audio])[0]
                self._send(200, {"embedding": np.asarray(emb).tolist()})
            elif path == "/contrast":
                other = _safe_db_file(q["other"], predictor.audio_db_path)
                if other is None or not os.path.isfile(other):
                    self._send(400, {"error": "'other' must name a file "
                                              "inside audio_db"})
                    return
                f1, f2 = _embed_many([audio, other])
                self._send(200, {"score": predictor.cosine_score(f1, f2)})
            elif path == "/register":
                if not _safe_user_name(q.get("name", "")):
                    self._send(400, {"error": "invalid user name"})
                    return
                with _db_lock:
                    ok, msg = predictor.register(audio, q["name"])
                self._send(200, {"success": bool(ok), "message": msg})
            elif path == "/recognition":
                # per-request override; never mutates the shared
                # predictor (threshold=0.0 is a valid accept-best)
                thr = float(q["threshold"]) if "threshold" in q else None
                emb = _embed_many([audio])[0]
                with _db_lock:
                    name, score = predictor.retrieve(emb[None],
                                                     threshold=thr)[0]
                self._send(200, {"name": name, "score": score})
            elif path == "/diarization":
                spk = int(q["speakers"]) if "speakers" in q else None
                search = q.get("search_db", "").lower() in ("1", "true",
                                                            "yes")
                thr = float(q["threshold"]) if "threshold" in q else None
                with _db_lock:
                    segs = predictor.speaker_diarization(
                        audio, speaker_num=spk, search_audio_db=search,
                        threshold=thr)
                self._send(200, {"segments": segs})
            else:
                self._send(404, {"error": "unknown endpoint"})

        def log_message(self, fmt, *args):
            pass  # quiet

    return Handler


class ServingHTTPServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` that hands each request to one of at most
    ``workers`` long-lived threads instead of a new thread per request,
    with a listen backlog for many concurrent clients (the stdlib default
    of 5 resets connections past that).

    Long-lived threads matter on the card: the first cuDNN call in a
    thread creates its cuDNN handle, and the plain FCM (buckets under 1000
    frames) then takes about 31 ms instead of 2 ms (NVIDIA H100 80GB HBM3,
    700 W). A new thread per request paid that on every request.

    A request goes to the thread that went idle last; a thread is idle
    again once its handler has answered, before it closes the connection.
    A request that finds every thread busy waits in arrival order, and
    takes the first thread that frees; only if none frees within
    ``spawn_after_s`` (and fewer than ``workers`` exist) do new threads
    start. So a client's next request, which can arrive before the thread
    that answered it is free again, finds that thread (a
    ``ThreadPoolExecutor`` started another one then), and a burst of
    concurrent requests still grows the pool at once."""

    request_queue_size = 256
    workers = 64
    spawn_after_s = 0.01

    def __init__(self, server_address, handler):
        super().__init__(server_address, handler)
        self._lock = threading.Lock()
        self._idle = []                      # inboxes of idle threads
        self._waiting = collections.deque()  # requests no thread took yet
        self._serving = []
        self._timer = None
        self._closing = False

    def process_request(self, request, client_address):
        with self._lock:
            if self._idle:
                self._idle.pop().put((request, client_address))
                return
            self._waiting.append((request, client_address))
            if not self._serving:
                self._start_threads()
            elif len(self._serving) < self.workers and self._timer is None:
                self._timer = threading.Timer(self.spawn_after_s,
                                              self._spawn_for_waiting)
                self._timer.daemon = True
                self._timer.start()

    def _spawn_for_waiting(self):
        with self._lock:
            self._timer = None
            self._start_threads()

    def _start_threads(self):
        """A new thread for each waiting request, up to ``workers``; the
        caller holds the lock."""
        while (self._waiting and len(self._serving) < self.workers
               and not self._closing):
            inbox = queue.SimpleQueue()
            inbox.put(self._waiting.popleft())
            thread = threading.Thread(
                target=self._serve_inbox, args=(inbox,),
                name=f"serve_{len(self._serving)}", daemon=True)
            self._serving.append(thread)
            thread.start()

    def _serve_inbox(self, inbox):
        while (job := inbox.get()) is not None:
            request, client_address = job
            try:
                self.finish_request(request, client_address)
            except Exception:  # noqa: BLE001 - as ThreadingMixIn does
                self.handle_error(request, client_address)
            finally:
                with self._lock:
                    if self._waiting:
                        inbox.put(self._waiting.popleft())
                    elif self._closing:
                        inbox.put(None)
                    else:
                        self._idle.append(inbox)
                self.shutdown_request(request)

    def server_close(self):
        """Close the socket, let the threads finish the requests they hold
        and the waiting ones, and join them."""
        super().server_close()
        with self._lock:
            self._closing = True
            if self._timer is not None:
                self._timer.cancel()
            for inbox in self._idle:
                inbox.put(None)
            self._idle.clear()
            threads = list(self._serving)
        for thread in threads:
            thread.join()


def warmup(predictor, seconds):
    """Embed one non-silent clip of each duration, so the first requests
    find the kernels loaded and the allocator warm."""
    for dur in seconds:
        wave_ = np.zeros((int(16000 * dur),), np.float32)
        wave_[::321] = 0.05  # non-silent so normalize has a level
        predictor.predict(wave_)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arg = functools.partial(add_arguments, argparser=parser)
    add_arg("configs",       str,   "configs/cam++.yml", "config file path")
    add_arg("model_path",    str,   "models/CAMPPlus_Fbank/best_model/",
            "model.pt or its directory")
    add_arg("audio_db_path", str,   "audio_db/", "voiceprint database")
    add_arg("threshold",     float, 0.6, "recognition threshold")
    add_arg("host",          str,   "127.0.0.1", "bind address")
    add_arg("port",          int,   8000, "port")
    add_arg("device",        str,   "cuda", "torch device: cuda or cpu "
            "(cuda raises without a CUDA device)")
    add_arg("data_parallel", bool,  False, "split embedding batches over "
            "every visible CUDA device")
    add_arg("dynamic_batch_ms", float, 0.0, "aggregate concurrent embed "
            "requests for up to this many ms into one device batch "
            "(0 disables)")
    add_arg("dynamic_batch_max", int, 64, "max clips per dynamic batch")
    add_arg("warmup_seconds", str,  "", "comma-separated durations (e.g. "
            "'3,5') to embed once before serving")
    args = parser.parse_args(argv)
    print_arguments(args=args)

    predictor = Predictor(configs=args.configs, model_path=args.model_path,
                          audio_db_path=args.audio_db_path,
                          threshold=args.threshold, device=args.device,
                          data_parallel=args.data_parallel)
    if args.warmup_seconds.strip():
        warmup(predictor, [float(s) for s in args.warmup_seconds.split(",")])
        print("warmup done", flush=True)
    batcher = None
    if args.dynamic_batch_ms > 0:
        batcher = MicroBatcher(predictor, window_ms=args.dynamic_batch_ms,
                               max_batch=args.dynamic_batch_max)
        print(f"dynamic batching: {args.dynamic_batch_ms:g} ms window, "
              f"max {args.dynamic_batch_max}", flush=True)
    server = ServingHTTPServer((args.host, args.port),
                               make_handler(predictor, batcher))
    print(f"serving on http://{args.host}:{server.server_address[1]}",
          flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
