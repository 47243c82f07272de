"""Device idle ms a frame of the codec: idle whose innermost program span
is ``datagen.codec`` or ``codec.encode`` (``parallel/codec.py``)."""

from port_bench.metrics.spans import idle_ms_per_unit, within


def read(ctx):
    return idle_ms_per_unit(ctx, within(("datagen.codec", "codec.")))
