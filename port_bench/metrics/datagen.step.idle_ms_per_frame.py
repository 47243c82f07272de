"""Device idle ms a frame of the datagen's cloth step: idle whose innermost
program span is ``datagen.step`` or a ``cloth.*`` span inside it (the
parameters' packing and K5r's issue)."""

from port_bench.metrics.spans import idle_ms_per_unit, within


def read(ctx):
    return idle_ms_per_unit(ctx, within(("datagen.step",)))
