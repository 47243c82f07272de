"""Reading a ``torch.profiler`` trace of a few units of a cell.

The harness runs one unit more than it keeps, each unit inside a
``bench.unit`` range, and synchronises at the end; :func:`read` keeps the
device operations launched inside the kept units (matched to their launch
by correlation id), assigns each the innermost program range around its
launch (``datagen.step``, ``datagen.render``, ``datagen.codec``,
``datagen.fetch``), and measures the device's busy time as the union of
their spans over the kept window. A trace in which a kernel launched
inside a kept unit has no device record is flagged: the profiler has been
seen to drop records, so the harness takes it again.
"""

from __future__ import annotations

import collections
import json
from typing import List, NamedTuple, Tuple

UNIT = "bench.unit"
WORK = "bench.work"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "user_annotation")


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start: float      # µs
    dur: float        # µs
    owner: str        # innermost program range at its launch, "" if none


class Trace(NamedTuple):
    ops: List[DeviceOp]
    units: int
    window_us: float
    busy_us: float
    missing: int      # kernel launches in the kept units with no record
    launched: int
    gaps: List[Tuple[str, float]]   # longest idle gaps (host activity, µs)


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(path: str, skip: int = 1,
         owners: Tuple[str, ...] = ("datagen.", WORK)) -> Trace:
    """The trace at ``path``: the ``bench.unit`` ranges after the first
    ``skip`` are kept; operations launched inside a ``bench.work`` range
    (the harness's own bookkeeping) are left out."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    units = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] == UNIT)
    kept = units[skip:]
    if not kept:
        raise ValueError(f"{path}: {len(units)} {UNIT} ranges, none kept")
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation"
              and e["name"].startswith(owners)]
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})]

    def in_kept(t):
        return any(a <= t <= b for a, b in kept)

    launch = {e["args"]["correlation"]: e["ts"] for e in runtime
              if in_kept(e["ts"])}
    ops = []
    recorded = set()
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        recorded.add(corr)
        t = launch.get(corr)
        if t is None:
            continue
        own = [r for r in ranges if r[0] <= t <= r[1]]
        owner = min(own, key=lambda r: r[1] - r[0])[2] if own else ""
        if owner == WORK:
            continue
        ops.append(DeviceOp(e["name"], e["cat"], e["ts"], e["dur"], owner))
    kernels = [e["args"]["correlation"] for e in runtime
               if "Launch" in e["name"] and in_kept(e["ts"])]
    missing = sum(c not in recorded for c in kernels)
    t0 = kept[0][0]
    t1 = max([kept[-1][1]] + [o.start + o.dur for o in ops])
    busy = _merged((o.start, o.start + o.dur) for o in ops)
    busy_us = sum(b - a for a, b in busy)
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in HOST_CATS and e["name"] != UNIT]
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    idle = sorted(((a, b) for a, b in zip(edges[0::2], edges[1::2])
                   if b > a), key=lambda g: g[0] - g[1])[:10]
    gaps = []
    for a, b in idle:
        active = [h for h in host if h[0] <= a < h[1]]
        name = (min(active, key=lambda h: h[1] - h[0])[2] if active
                else "host idle")
        gaps.append((name, b - a))
    return Trace(ops, len(kept), t1 - t0, busy_us, missing, len(kernels),
                 gaps)


def top_ops(tr: Trace, n: int = 10) -> List[Tuple[str, float]]:
    """The ``n`` device operations that took most time, ``(name, s)``."""
    by = collections.Counter()
    for o in tr.ops:
        by[o.name[:120]] += o.dur
    return [(k, v * 1e-6) for k, v in by.most_common(n)]
