"""Device ms a frame of the operations launched inside ``render.shade``
(``render/raster.py`` ``draw_instanced_spheres``: from the nearest hit to
the colour of each pixel)."""

from port_bench.metrics.spans import launched_ms_per_unit


def read(ctx):
    return launched_ms_per_unit(ctx, "render.shade")
