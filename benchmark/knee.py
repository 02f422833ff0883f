"""The knee of ``/embedding`` serving, found once by a sweep on the card:
``python3 -m benchmark.knee --config campplus --traffic serve_poisson
--seed <n> --seconds <s> --rates 100,200,...``. One server is built as the cell
builds it; each rate gets its own open-loop window from a fresh child.
Prints one line a rate: requests, p50 and p95 latency from due, failed,
the backlog (median latency of the window's last fifth over its first
fifth), the generator's p99 lateness and the requests per micro-batch.
The knee is the highest rate whose p95 stays at or under ``--limit_ms``
with a backlog under ``--max_backlog``."""

import argparse
import json
import sys
import tempfile
import time

from . import core
from .entries.http_open_loop import Serving, summarize
from .trace import Spans


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="campplus")
    p.add_argument("--traffic", default="serve_poisson")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", required=True)
    p.add_argument("--limit_ms", type=float, default=50.0)
    p.add_argument("--max_backlog", type=float, default=1.5)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 2
    config, traffic = core.files(args.config, args.traffic)
    ctx = core.Context(config, traffic, args.seed, args.seconds, False,
                       torch.device("cuda", 0), Spans(), tempfile.mkdtemp(),
                       time.perf_counter())
    srv = Serving(ctx)
    knee = None
    try:
        for rate in [float(r) for r in args.rates.split(",")]:
            b0, i0 = srv.batcher.batches, srv.batcher.items
            res = srv.window(rate, args.seconds, args.seed)
            p95, failed, backlog, late = summarize(res, args.seconds)
            lat = [args.seconds * 1e3 if v is None else v for v in res["latency_ms"]]
            row = {"rate": rate, "requests": len(lat),
                   "p50_ms": core.quantile(lat, 0.5), "p95_ms": p95,
                   "failed": failed, "backlog": backlog,
                   "generator_p99_late_ms": late,
                   "items_per_batch": (srv.batcher.items - i0)
                   / max(1, srv.batcher.batches - b0)}
            print(json.dumps(row), flush=True)
            if p95 <= args.limit_ms and backlog < args.max_backlog and not failed:
                knee = rate
    finally:
        srv.close()
    print(json.dumps({"knee": knee, "limit_ms": args.limit_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
