"""Device ms a frame of the codec (``parallel/codec.py`` ``encode``): the
device time launched inside ``datagen.codec``, over the frames."""

from port_bench.metrics.common import owned_us


def read(ctx):
    tr = ctx["trace"]
    return owned_us(tr, "datagen.codec") * 1e-3 / tr.units
