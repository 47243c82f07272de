"""Device idle ms a unit of the scene (``models/scenes.py``
``ClothScene.simulate``): idle whose innermost program span is
``scene.simulate`` or a ``cloth.*`` span inside it (the parameters' packing,
``cloth.pack``, and the launches' issue, ``cloth.issue``)."""

from port_bench.metrics.spans import idle_ms_per_unit, within


def read(ctx):
    return idle_ms_per_unit(ctx, within(("scene.",)))
