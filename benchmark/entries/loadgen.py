"""Open-loop load generator for ``/embedding``, run as a child process
(``python3 -m benchmark.entries.loadgen <plan.json>``) so that it shares
no GIL with the server. Standard library only.

The plan names the server's port, a file of WAV bodies with their
offsets, and two schedules of (due seconds, body index): a warm-up and
the window. Request ``i`` is sent by thread ``i % threads`` at its due
time, over a connection of its own, and timed from when it was due, so a
stall of the server or of this process counts against every request it
delays. The child runs the warm-up, prints ``ready``, waits for a line on
standard input, runs the window and prints one JSON line: per request its
latency from due (ms, or null if it failed), how late it was sent (ms)
and, for the requests the plan samples, the embedding it got."""

import http.client
import json
import sys
import threading
import time


def _send(port, body, timeout):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/embedding", body,
                     {"Content-Type": "audio/wav"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            return None
        emb = json.loads(data)["embedding"]
        return emb if len(emb) > 0 else None
    finally:
        conn.close()


def run_schedule(port, bodies, schedule, n_threads, timeout, keep=()):
    keep = set(keep)
    n = len(schedule)
    lat, late, embs = [None] * n, [0.0] * n, {}
    t0 = time.perf_counter() + 0.05

    def worker(k):
        for i in range(k, n, n_threads):
            due = t0 + schedule[i][0]
            now = time.perf_counter()
            if due > now:
                time.sleep(due - now)
            late[i] = max(0.0, time.perf_counter() - due) * 1e3
            try:
                emb = _send(port, bodies[schedule[i][1]], timeout)
            except Exception:  # noqa: BLE001 - a failed request is a miss
                emb = None
            if emb is not None:
                lat[i] = (time.perf_counter() - due) * 1e3
                if i in keep:
                    embs[i] = emb

    threads = [threading.Thread(target=worker, args=(k,), daemon=True)
               for k in range(min(n_threads, n))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return {"latency_ms": lat, "late_ms": late,
            "embeddings": {str(i): e for i, e in embs.items()},
            "span_s": time.perf_counter() - t0}


def main(path):
    with open(path, encoding="utf-8") as f:
        plan = json.load(f)
    with open(plan["bodies"], "rb") as f:
        blob = f.read()
    offs = plan["offsets"]
    bodies = [blob[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]
    run_schedule(plan["port"], bodies, plan["warmup"], plan["threads"],
                 plan["timeout_s"])
    print("ready", flush=True)
    sys.stdin.readline()
    out = run_schedule(plan["port"], bodies, plan["window"], plan["threads"],
                       plan["timeout_s"], plan["keep"])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
