"""What every cell shares: the cell's files found by name, the run's
context, the arithmetic of rates and percentiles, the check for JAX in
``sys.modules`` and the result line."""

import importlib
import importlib.util
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# what the process may not hold once the window has closed (top-level
# module names, compared whole)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax",
                       "voiceprintrecognition_paddlepaddle_tpu"})
PORT = "voiceprintrecognition_paddlepaddle_torch"


def load_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def spec():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_files(workload):
    """The cell of ``BENCHMARK.json`` named ``workload``: (cell, config
    entry, config file's dict, traffic file's dict)."""
    s = spec()
    cells = {w["name"]: w for w in s["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    listed = {c["name"]: c for c in s["configs"]}[cell["config"]]
    return (cell, listed) + files(cell["config"], cell["traffic"])


def files(config, traffic):
    """``configs/<config>.json`` and ``traffic/<traffic>.json`` as dicts,
    for a pair that is a cell or is not one yet."""
    return (load_json(os.path.join(HERE, "configs", config + ".json")),
            load_json(os.path.join(HERE, "traffic", traffic + ".json")))


def cell_metrics(workload, kind):
    """The ``end_to_end`` or ``per_layer`` entries that ``workload`` reports."""
    return [m for m in spec()[kind]
            if "workloads" not in m or workload in m["workloads"]]


def entry(name):
    """The module ``entries/<name>.py`` a traffic file names."""
    return importlib.import_module(f"benchmark.entries.{name}")


def reference(config):
    """The plain reference module a configuration file names under
    ``reference`` (a path under the benchmark's folder): it holds the
    model class ``Model`` and ``forward_flops(frames, rows)``, the whole
    forward of one clip from its valid frames and trunk rows."""
    rel = os.path.splitext(os.path.normpath(config["reference"]))[0]
    return importlib.import_module(rel.replace(os.sep, "."))


def reader(metric_name):
    """``metrics/<metric_name>.py`` (the name holds dots, so it is loaded
    from its file)."""
    path = os.path.join(HERE, "metrics", metric_name + ".py")
    spec_ = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


class Context:
    """One run: the cell's configuration and traffic files, the seed, the
    window's length, whether it is traced, the device, the harness's spans,
    a scratch directory under ``TMPDIR`` and the process's start."""

    def __init__(self, config, traffic, seed, seconds, trace, device,
                 spans, tmpdir, t0):
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.spans, self.tmpdir, self.t0 = device, spans, tmpdir, t0


class Outcome:
    """What an entry hands back after its window.

    ``setup_s``: process start to the window's start. ``e2e``: the cell's
    end-to-end metrics by name. ``attempted`` / ``failed``: requests,
    batches or steps due in the window and those that failed. ``reading``:
    what the per-layer readers read (``trace``, ``spans``, ``counters``,
    ``work``, ``window_s``, ``config``). ``free()`` drops the program's
    state; ``check()`` then returns ``[(name, value, limit), ...]``."""

    def __init__(self, setup_s, e2e, attempted, failed, reading, free, check):
        self.setup_s, self.e2e = setup_s, e2e
        self.attempted, self.failed = attempted, failed
        self.reading, self.free, self.check = reading, free, check


def quantile(values, q):
    """The ``q`` quantile (0..1) of ``values``, linear between order
    statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = q * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count, seconds):
    """Work per second over all the work and all the time of a window."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return count / seconds


def forbidden_modules(modules=None):
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)


def correct(compared):
    """A run is correct when it compared something and every number is
    within its limit."""
    return bool(compared) and all(v <= lim for _, v, lim in compared)


def limit(config, name):
    return float(config["limits"][name])


def result_line(correct, attempted, failed, metrics, device, compared,
                breakdown=None):
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return json.dumps(out)
