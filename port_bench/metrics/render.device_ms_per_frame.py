"""Device ms a frame of the sphere render (``render/raster.py``
``draw_instanced_spheres``: binning, rays, the depth test and the
composite over the cached globe, the uint8 cast): the device time launched
inside ``datagen.render``, less the raster kernels (``sphere_raster.cu``:
the work list's ``plan_*`` and ``sphere_raster_*``), over the frames."""

from port_bench.metrics.common import owned_us

RASTER = r"sphere_raster|plan_(count|scan|runs|fill)"


def read(ctx):
    tr = ctx["trace"]
    return owned_us(tr, "datagen.render", RASTER) * 1e-3 / tr.units
