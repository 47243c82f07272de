"""What the span metric readers share: the device's idle time put down to
the program's layers, host time in a span a launch, device time launched
inside a span, and the host's synchronisations, each a unit.

They read ``ctx["spans"]`` (``port_bench/trace_spans.read``) and return
nothing where a trace has no program span to read (a program without the
spans, or a cell that does not run the layer).

Each idle interval of the device goes to the innermost program span (the
shortest) active at its start on any thread; one with none active goes
to the outside of the program (the cell's ``drivers/`` module with its
copy and sync, autograd's engine between segments, Python between
calls). A
layer is the set of spans named in its predicate: the cloth's ``cloth.*``
spans belong to the layer whose span encloses them (the scene, the
gradient, the datagen's step), so the layers and the outside partition the
idle time.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from port_bench.trace_spans import Span

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")

# a layer: the spans active at an idle interval's start, innermost first
Layer = Callable[[List[Span]], bool]


def spans_of(ctx):
    """The trace's spans, or ``None`` where it has no program span."""
    sp = ctx.get("spans")
    return sp if sp is not None and sp.spans else None


def active(sp, t: float) -> List[Span]:
    """The program spans open at ``t`` on any thread, innermost first."""
    return sorted((s for s in sp.spans if s.start <= t < s.end),
                  key=lambda s: s.end - s.start)


def within(names) -> Layer:
    """A layer of spans: the innermost is one of ``names`` (a name ending
    in ``.`` a prefix), or a ``cloth.*`` span that one of them encloses."""
    def match(s):
        return any(s.name == n or (n.endswith(".") and s.name.startswith(n))
                   for n in names)

    def layer(act):
        if match(act[0]):
            return True
        return act[0].name.startswith("cloth.") and any(map(match, act[1:]))
    return layer


def idle_ms_per_unit(ctx, layer: Optional[Layer]):
    """Device idle ms a unit whose innermost span belongs to ``layer``
    (``None``: no program span active, the outside of the program);
    nothing where no span of ``layer`` was recorded."""
    sp = spans_of(ctx)
    if sp is None or (layer and not any(layer([s]) for s in sp.spans)):
        return None
    us = 0.0
    for a, b in sp.idle:
        act = active(sp, a)
        if (not act) if layer is None else (act and layer(act)):
            us += b - a
    return us * 1e-3 / sp.units


def launched_ms_per_unit(ctx, name: str):
    """Device ms a unit of the operations launched inside span ``name``
    on the launching thread."""
    sp = spans_of(ctx)
    if sp is None or not any(s.name == name for s in sp.spans):
        return None
    inside = [s for s in sp.spans if s.name == name]
    us = sum(o.dur for o in sp.ops
             if any(s.tid == o.tid and s.start <= o.launch <= s.end
                    for s in inside))
    return us * 1e-3 / sp.units


def host_us_per_launch(ctx, name: str):
    """Host µs in spans ``name`` over the kernel launches made inside them
    on their thread."""
    sp = spans_of(ctx)
    inside = [] if sp is None else [s for s in sp.spans if s.name == name]
    launches = sum(1 for r in (sp.runtime if inside else ())
                   if "Launch" in r.name
                   and any(s.tid == r.tid and s.start <= r.start <= s.end
                           for s in inside))
    if not launches:
        return None
    return sum(s.end - s.start for s in inside) / launches


def syncs_per_unit(ctx):
    """Synchronising runtime calls made inside a program span (on its
    thread), a unit."""
    sp = spans_of(ctx)
    if sp is None:
        return None
    n = sum(1 for r in sp.runtime if r.name in SYNCS
            and any(s.tid == r.tid and s.start <= r.start <= s.end
                    for s in sp.spans))
    return n / sp.units
