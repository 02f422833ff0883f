"""One run of one cell: ``python3 -m benchmark.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout.

Set-up (loading, weights, packing, warm-up) counts from the start of the
process. The window measures for ``--seconds``; with ``--trace 1`` the
profiler records it and the cell's per-layer metrics are read from that
record, otherwise the end-to-end metrics are taken by the host's clock.
Then ``memory_peak_bytes`` is read, the program's state freed and the
outputs of the window compared with the plain reference. The last line
of standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

Build and kernel caches stay inside the checkout at fixed paths
(``build/``), scratch files under ``TMPDIR``. The run exits with 2 and no
result on a host without the CUDA devices the cell asks for, and with 3
if JAX or the JAX package is loaded once the window has closed."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import core  # noqa: E402

_CACHE = os.path.join(core.ROOT, "build", "bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(_CACHE, _sub)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def err(msg):
    print(msg, file=sys.stderr, flush=True)


def device_info(torch, device, trace=None):
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def main(argv=None):
    args = parse(argv)
    cell, _, config, traffic = core.cell_files(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        err(f"{args.workload} needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from .trace import Spans
    tmpdir = tempfile.mkdtemp(prefix="bench_")
    try:
        ctx = core.Context(config, traffic, args.seed, args.seconds,
                           args.trace, device, Spans(), tmpdir, T0)
        out = core.entry(traffic["entry"]).run(ctx)
        torch.cuda.synchronize(device)
        dev = device_info(torch, device, out.reading.get("trace") if args.trace else None)
        if args.trace:
            metrics, breakdown = read_layers(args.workload, out.reading), \
                out.reading["trace"].breakdown()
        else:
            metrics, breakdown = end_to_end(args.workload, out), None
        out.free()
        torch.cuda.empty_cache()
        compared = out.check()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    found = core.forbidden_modules()
    if found:
        err(f"the run loaded {found}: the benchmark runs the port alone")
        return 3
    correct = core.correct(compared)
    for name, v, lim in compared:
        err(f"compared {name}: {v!r} (limit {lim!r})")
    print(core.result_line(
        correct, out.attempted, out.failed, metrics, dev,
        {n: {"value": v, "limit": lim} for n, v, lim in compared}, breakdown),
        flush=True)
    return 0


def end_to_end(workload, out):
    metrics = {}
    for m in core.cell_metrics(workload, "end_to_end"):
        value = out.setup_s if m["name"] == "setup_s" else out.e2e[m["name"]]
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def read_layers(workload, reading):
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing returns None and the metric is left out."""
    metrics = {}
    for m in core.cell_metrics(workload, "per_layer"):
        value = core.reader(m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


if __name__ == "__main__":
    sys.exit(main())
