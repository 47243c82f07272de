"""Device idle ms a frame of the datagen's fetch: idle whose innermost
program span is ``datagen.fetch`` (a frame's copy to pinned memory set
going) or ``fetch.wait`` (the host waiting for a frame to land)."""

from port_bench.metrics.spans import idle_ms_per_unit, within


def read(ctx):
    return idle_ms_per_unit(ctx, within(("datagen.fetch", "fetch.")))
