"""The benchmark's harness: one run of one cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<file>``) and a traffic mix
(``traffic/<traffic>.json``). The mix names its driver
(``drivers/<driver>.py``), which builds the cell's inputs from the seed,
drives the program's entry point one unit of work at a time (a closed
loop), keeps the sampled units' inputs and outputs, and checks them
against the plain reference (``reference/``) once the window has closed.
Each per-layer metric is a reader of its own (``metrics/<name>.py``).
Nothing here names a cell: a later cell, configuration, traffic mix or
metric is a new file and a new entry.

A run: set-up (inputs, the program's state, a warm-up that builds and
loads every kernel the cell's path uses), then either the timed window
(``--trace 0``: the cell's end-to-end metrics) or, first, a profiled
stretch of ``trace_units`` units (``--trace 1``: its per-layer metrics),
then the window, the launch guard (every kernel the mix names must have
launched in the window), the reference's check of the sampled units, and
one JSON line.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that may not be loaded: JAX and the JAX package
# (the port's own name begins with the JAX package's, so names are
# compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "wgpu_physics_engine_tpu")


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among module ``names`` (default:
    those ``sys.modules`` holds)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_json(rel: str):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


def cell_spec(workload: str, bench: Dict = None) -> Dict:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration,
    traffic mix and the metrics it reports."""
    bench = bench or load_json("BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def applies(m):
        return workload in m.get("workloads", [workload])

    return {"cell": cell, "config": load_json(conf["file"]),
            "traffic": load_json(os.path.join(
                "port_bench", "traffic", cell["traffic"] + ".json")),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def read_counters(names) -> Dict[str, int]:
    """Launch counters ``module:ATTR`` of the program."""
    out = {}
    for name in names:
        mod, attr = name.split(":")
        out[name] = int(getattr(importlib.import_module(mod), attr))
    return out


def load_metric(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or
    for a metric ``<base>.<variant>`` without a file of its own (one
    quantity split by the end-to-end metric it moves) ``metrics/<base>.py``."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(BENCH, "metrics", name.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location(
        "port_bench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worst(a: float, b: float) -> float:
    """The larger of two gaps, where a gap that is not a finite number
    (NaN, inf) is the worst of all."""
    if not math.isfinite(a):
        return a
    if not math.isfinite(b):
        return b
    return max(a, b)


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    "" where it cannot be read: a card set below 700 W runs slower."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0].strip() if out.strip() else ""


def p95(values) -> float:
    """The 95th percentile (linear between order statistics)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


class IncompleteTrace(RuntimeError):
    """Every try at a trace lost the device record of some kernel launch."""


def traced(cell, units: int, tries: int = 3):
    """Profile ``units`` units of ``cell`` (after one more that warms the
    tracer up); retaken while a kept kernel launch has no device record,
    and :class:`IncompleteTrace` after ``tries`` such traces, since the
    per-layer metrics would read device time that is not there."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace

    for attempt in range(1, tries + 1):
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                it = cell.units(traced=True)
                for _ in range(units + 1):
                    with record_function(trace.UNIT):
                        next(it)
                it.close()
                torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            tr = trace.read(path, skip=1)
        if tr.launched and not tr.missing:
            return tr
        print(f"trace attempt {attempt}: {tr.missing} of {tr.launched} "
              f"kernel launches have no device record", file=sys.stderr)
    raise IncompleteTrace(f"{tries} traces, each with kernel launches "
                          f"that have no device record (last: {tr.missing} "
                          f"of {tr.launched})")


def run_cell(spec: Dict, seed: int, seconds: float, trace_on: bool,
             device: str, t_start: float) -> Dict:
    """One run; returns the result object (without printing it)."""
    import torch

    traffic = spec["traffic"]
    driver = importlib.import_module("port_bench.drivers."
                                     + traffic["driver"])
    cell = driver.Cell(spec["config"], traffic, seed, device)
    cell.warm_up()
    tr = traced(cell, traffic["trace_units"]) if trace_on else None
    cell.plan(random.Random(seed))
    c0 = read_counters(traffic["launch_counters"])
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    issue, done = [], []
    it = cell.units()
    for t_issue, t_done in it:
        issue.append(t_issue)
        done.append(t_done)
        if t_done - t0 >= seconds:
            break
    it.close()
    if device != "cpu":
        torch.cuda.synchronize()
    window_s = done[-1] - t0
    mem = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    c1 = read_counters(traffic["launch_counters"])
    work = cell.work() if trace_on else None
    cell.free()
    readings = cell.check()

    checks = {}
    failed = 0
    for name, value in readings.items():
        limit = traffic["limits"][name]
        checks[name] = {"value": value, "limit": limit}
        if not (math.isfinite(value) and value <= limit):
            failed += 1
    launches_ok = True
    for name in traffic["launch_counters"]:
        short = traffic["launch_counters"][name]
        checks[short] = {"value": c1[name] - c0[name], "limit": 1}
        launches_ok &= c1[name] - c0[name] >= 1
    n = len(done)
    lat = [(b - a) * 1e3 for a, b in zip(issue, done)]
    if trace_on:
        ctx = {"trace": tr, "work": work, "config": spec["config"],
               "traffic": traffic}
        metrics = {}
        for m in spec["per_layer"]:
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {traffic["rate"]: n * cell.unit_work / window_s,
                  "latency_ms_p95": p95(lat), "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": spec["cell"]["chips"], "memory_peak_bytes": mem,
           "card": (card_name_and_power_limit() if device != "cpu"
                    else "")}
    out = {"correct": failed == 0 and launches_ok and n > 0,
           "attempted": n, "failed": failed if launches_ok else n,
           "metrics": metrics, "device": dev}
    if trace_on:
        from . import trace

        dev["busy_s"] = tr.busy_us * 1e-6
        dev["window_s"] = tr.window_us * 1e-6
        out["breakdown"] = {"device_ops": [list(x) for x in trace.top_ops(tr)],
                            "idle_gaps": [[g, s * 1e-6] for g, s in tr.gaps]}
    out["checks"] = checks
    return out
