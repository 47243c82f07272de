"""The program's own spans in a ``torch.profiler`` trace of a few units
of a cell, beside what :func:`port_bench.trace.read` keeps.

The port opens a ``record_function`` range at each of its layer
boundaries while a profiler records (``utils/profiling.span``): the scene
call, the cloth parameters' packing and its launches' issue, the gradient's
segments and adjoint, the render's split, the codec, the wait for a
frame. :func:`read` keeps, in the kept ``bench.unit`` ranges of a trace
that ``trace.read`` has read,

* the program spans (a ``user_annotation`` range whose name begins with
  one of :data:`PREFIXES`) on every thread, autograd's included;
* the host's CUDA runtime calls (launches, copies, synchronisations);
* the device operations with the time and thread of their launch;
* every idle interval of the device over the kept window (the window and
  the busy union of ``trace.read``, so that they sum to ``window_us -
  busy_us``).

Every cell is a closed loop and a ``bench.unit`` range encloses a unit's
spans on every thread, so per-unit figures need no span ids.
"""

from __future__ import annotations

import json
from typing import List, NamedTuple, Tuple

from . import trace

PREFIXES = ("scene.", "cloth.", "grad.", "render.", "codec.", "fetch.",
            "datagen.", "granular.", "mesh.")


class Span(NamedTuple):
    name: str
    tid: int
    start: float      # µs
    end: float        # µs


class Op(NamedTuple):
    dur: float        # µs of device time
    launch: float     # µs, the host's launch call
    tid: int          # the launching thread


class Spans(NamedTuple):
    units: int
    spans: List[Span]                 # program spans in the kept units
    runtime: List[Span]               # CUDA runtime calls in the kept units
    ops: List[Op]                     # device operations launched in them
    idle: List[Tuple[float, float]]   # every idle interval of the window


def read(path: str, tr: trace.Trace, skip: int = 1) -> Spans:
    """The spans of the trace at ``path``, of which ``tr`` is
    ``trace.read(path, skip)``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kept = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation"
                  and e["name"] == trace.UNIT)[skip:]

    def in_kept(t):
        return any(a <= t <= b for a, b in kept)

    def span(e):
        return Span(e["name"], e.get("tid"), e["ts"], e["ts"] + e["dur"])

    spans = sorted((span(e) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith(PREFIXES) and in_kept(e["ts"])),
                   key=lambda s: s.start)
    runtime = [e for e in events if e.get("cat") == "cuda_runtime"
               and in_kept(e["ts"])]
    launch = {e["args"]["correlation"]: e for e in runtime
              if "correlation" in e.get("args", {})}
    work = [span(e) for e in events if e.get("cat") == "user_annotation"
            and e["name"] == trace.WORK]
    ops = []
    for e in events:
        src = launch.get(e.get("args", {}).get("correlation"))
        if e.get("cat") not in trace.DEVICE_CATS or src is None:
            continue
        if any(w.start <= src["ts"] <= w.end for w in work):
            continue          # the harness's own bookkeeping
        ops.append(Op(e["dur"], src["ts"], src.get("tid")))
    t0 = kept[0][0]
    t1 = t0 + tr.window_us
    busy = trace._merged((o.start, o.start + o.dur) for o in tr.ops)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return Spans(len(kept), spans, [span(e) for e in runtime], ops, idle)
