"""Device ms a frame of the operations launched inside ``render.composite``
(``render/raster.py`` ``_composite``: the depth-tested write over the
cached globe)."""

from port_bench.metrics.spans import launched_ms_per_unit


def read(ctx):
    return launched_ms_per_unit(ctx, "render.composite")
