#!/usr/bin/env python3
"""Trace a few units of a benchmark cell with the program's spans kept,
and print the cell's per-layer metrics beside the span metrics.

    python3 tools/span_trace.py --workload cloth256-sim --seed 7 \\
        [--units 3] [--repeat 1] [--keep DIR]

Run from the root of a checkout, on the CUDA card. Set-up is the
harness's (the cell's driver, its inputs from the seed, its warm-up);
then, ``--repeat`` times, a ``torch.profiler`` stretch of ``--units``
units after one more that warms the tracer up, as
``port_bench/harness.py`` ``traced`` takes it, read by
``port_bench/trace.py`` and ``port_bench/trace_spans.py``. The harness
hands its readers ``trace.read``'s result alone and deletes the file, so
the span metrics of ``port_bench/metrics`` (``metrics/spans.py``) are read
here. Each stretch prints one JSON line:

* ``metrics``: the cell's per-layer metrics (``BENCHMARK.json``) and the
  span metrics of :data:`SPAN_METRICS`;
* ``idle_ms_per_unit``: the device's idle ms a unit (window less busy),
  ``idle_intervals_ms_per_unit``, its idle intervals summed (more where a
  traced operation starts before the first kept unit), and
  ``idle_sum_ms_per_unit``, the cell's idle metrics summed, which
  partition the intervals;
* ``idle_by_span``: the idle ms a unit by innermost program span
  (``""``: none active);
* ``span_ms_per_unit``: host ms a unit in each program span;
* ``syncs_by_span``: synchronising runtime calls a unit by the innermost
  span around them on their thread (``""``: none);
* ``unit_ms``: the host's ms of each kept ``bench.unit`` under the
  profiler, the cost of a traced unit to set beside another checkout's
  in turns on one card.

With ``--untraced SECONDS`` it first runs the cell's units for that
long with no profiler, by the host clock, and prints one more line,
``untraced``: the mean ms a unit, the host's ms a unit and µs a launch in
the calls that the ``cloth.issue`` and ``grad.adjoint.issue`` spans
enclose (:data:`ISSUE_SITES`, timed by wrappers of the port's functions),
and ``idle_ms_per_unit``, the unit less the traced stretches' device busy
time a unit: the idle that the profiler's own cost does not add.

``--keep DIR`` keeps each stretch's trace there. A stretch in which a
kept kernel launch has no device record is taken again, as the harness
does, up to three times. Like ``port_bench/run.py``, it needs the card:
without CUDA it prints no line and exits with 2, since a trace
with no device operations would read the whole window as idle.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness, trace, trace_spans  # noqa: E402
from port_bench.metrics import spans as span_metrics  # noqa: E402

SPAN_METRICS = {
    "datagen4096-codec": [
        "render.idle_ms_per_frame", "codec.idle_ms_per_frame",
        "datagen.step.idle_ms_per_frame", "datagen.fetch.idle_ms_per_frame",
        "render.shade.device_ms_per_frame",
        "render.composite.device_ms_per_frame",
        "idle_outside_program_ms_per_unit.datagen",
        "host_syncs_per_unit.datagen"],
    "datagen4096-states": [
        "datagen.step.idle_ms_per_frame", "datagen.fetch.idle_ms_per_frame",
        "idle_outside_program_ms_per_unit.datagen",
        "host_syncs_per_unit.datagen"],
    "cloth256-sim": [
        "scene.idle_ms_per_unit", "k1.issue_us_per_launch.sim",
        "idle_outside_program_ms_per_unit.sim", "host_syncs_per_unit.sim"],
    "cloth256-grad": [
        "grad.idle_ms_per_unit", "k1.issue_us_per_launch.grad",
        "idle_outside_program_ms_per_unit.grad", "host_syncs_per_unit.grad"],
}


# The port's calls that enqueue the cloth launches, each the body of a
# span (its name first), with the launch counters of its module that it
# advances.
ISSUE_SITES = (
    ("cloth.issue", "wgpu_physics_engine_torch.ops.cloth_kernel",
     "multi_step_launch_packed", ("LAUNCHES", "LAUNCHES_BATCHED")),
    ("cloth.issue", "wgpu_physics_engine_torch.ops.cloth_kernel",
     "trace_kernel", ("LAUNCHES",)),
    ("cloth.issue", "wgpu_physics_engine_torch.ops.cloth_tiled_kernel",
     "multi_step_batched_kernel_packed", ("LAUNCHES_BATCHED",)),
    ("grad.adjoint.issue", "wgpu_physics_engine_torch.ops.cloth_grad_kernel",
     "_walk_kernel", ("LAUNCHES", "LAUNCHES_WINDOW")),
)


def untraced(cell, seconds: float) -> dict:
    """The units of ``cell`` for ``seconds`` after one more, with no
    profiler: their mean ms by the host clock, and the host's time and
    the launches in each span's calls of :data:`ISSUE_SITES`."""
    host = collections.Counter()
    launches = collections.Counter()

    def timer(name, mod, fn, counters):
        def timed(*a, **kw):
            n0 = sum(getattr(mod, c) for c in counters)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[name] += time.perf_counter() - t0
                launches[name] += sum(getattr(mod, c) for c in counters) - n0
        return timed

    saved = []
    for name, module, attr, counters in ISSUE_SITES:
        mod = importlib.import_module(module)
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, timer(name, mod, getattr(mod, attr), counters))
    try:
        it = cell.units()
        next(it)
        host.clear()
        launches.clear()
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            next(it)
            n += 1
        wall = time.perf_counter() - t0
        it.close()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return {"units": n, "unit_ms": wall * 1e3 / n,
            "issue_ms_per_unit": {k: v * 1e3 / n for k, v in host.items()},
            "launches_per_unit": {k: v / n for k, v in launches.items()},
            "issue_us_per_launch": {k: host[k] * 1e6 / launches[k]
                                    for k in host if launches[k]}}


def profile(cell, units: int, path: str) -> None:
    """``units`` + 1 units of ``cell`` under ``torch.profiler``, each in a
    ``bench.unit`` range, exported to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        it = cell.units(traced=True)
        for _ in range(units + 1):
            with record_function(trace.UNIT):
                next(it)
        it.close()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def read_stretch(path: str, cell, spec, names) -> dict:
    """Every metric of ``names`` on the trace at ``path``, and the idle
    and host time by span."""
    tr = trace.read(path)
    sp = trace_spans.read(path, tr)
    ctx = {"trace": tr, "spans": sp, "work": cell.work(),
           "config": spec["config"], "traffic": spec["traffic"]}
    metrics = {n: harness.load_metric(n).read(ctx) for n in names}
    by_span = collections.Counter()
    for a, b in sp.idle:
        act = span_metrics.active(sp, a)
        by_span[act[0].name if act else ""] += (b - a) * 1e-3 / sp.units
    host = collections.Counter()
    for s in sp.spans:
        host[s.name] += (s.end - s.start) * 1e-3 / sp.units
    syncs = collections.Counter()
    for r in sp.runtime:
        if r.name in span_metrics.SYNCS:
            own = [s for s in sp.spans
                   if s.tid == r.tid and s.start <= r.start <= s.end]
            inner = min(own, key=lambda s: s.end - s.start) if own else None
            syncs[inner.name if inner else ""] += 1 / sp.units
    idle = [n for n in SPAN_METRICS.get(spec["cell"]["name"], [])
            if "idle_" in n and metrics.get(n) is not None]
    with open(path) as f:
        unit_ms = [e["dur"] * 1e-3 for e in sorted(
            (e for e in json.load(f)["traceEvents"]
             if e.get("cat") == "user_annotation"
             and e.get("name") == trace.UNIT and "dur" in e),
            key=lambda e: e["ts"])][1:]
    return {"metrics": metrics, "missing": tr.missing,
            "launched": tr.launched,
            "busy_ms_per_unit": tr.busy_us * 1e-3 / tr.units,
            "idle_ms_per_unit": (tr.window_us - tr.busy_us) * 1e-3 / tr.units,
            "idle_intervals_ms_per_unit": sum(
                b - a for a, b in sp.idle) * 1e-3 / sp.units,
            "idle_sum_ms_per_unit": sum(metrics[n] for n in idle),
            "idle_by_span": dict(by_span.most_common()),
            "span_ms_per_unit": dict(host.most_common()),
            "syncs_by_span": dict(syncs.most_common()),
            "unit_ms": unit_ms, "units": tr.units}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--keep", default=None)
    ap.add_argument("--untraced", type=float, default=0.0,
                    metavar="SECONDS")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("span_trace: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.cell_spec(args.workload)
    names = ([m["name"] for m in spec["per_layer"]]
             + SPAN_METRICS.get(args.workload, []))
    traffic = spec["traffic"]
    driver = importlib.import_module("port_bench.drivers."
                                     + traffic["driver"])
    cell = driver.Cell(spec["config"], traffic, args.seed, "cuda")
    cell.warm_up()
    setup_s = time.perf_counter() - t_start
    units = args.units or traffic["trace_units"]
    plain = untraced(cell, args.untraced) if args.untraced else None
    card = harness.card_name_and_power_limit()
    busy = []
    for k in range(args.repeat):
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(args.keep or d,
                                f"{args.workload}.{args.seed}.{k}.json")
            if args.keep:
                os.makedirs(args.keep, exist_ok=True)
            for attempt in range(1, 4):
                profile(cell, units, path)
                out = read_stretch(path, cell, spec, names)
                if out["launched"] and not out["missing"]:
                    break
        out.update(workload=args.workload, seed=args.seed, stretch=k,
                   attempts=attempt, setup_s=setup_s,
                   device=torch.cuda.get_device_name(0), card=card)
        busy.append(out["busy_ms_per_unit"])
        print(json.dumps(out), flush=True)
    if plain is not None:
        if busy:
            plain["idle_ms_per_unit"] = (plain["unit_ms"]
                                         - sum(busy) / len(busy))
        print(json.dumps({"untraced": plain, "workload": args.workload,
                          "seed": args.seed, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
