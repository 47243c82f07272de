"""Device idle ms a frame of the sphere render: idle whose innermost
program span is ``datagen.render`` or a ``render.*`` span
(``render/raster.py`` ``draw_instanced_spheres``: ``render.bin``,
``render.raster``, ``render.shade``, ``render.composite``)."""

from port_bench.metrics.spans import idle_ms_per_unit, within


def read(ctx):
    return idle_ms_per_unit(ctx, within(("datagen.render", "render.")))
