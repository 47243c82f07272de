"""K5r's share of its roofline (``ops/cloth_tiled_kernel.py`` →
``cloth_tiled.cu`` ``tiled_kernel<…, true>``, the resident batch of
worlds): the bound of the cloth calls the traced frames made (a call a
chunk of worlds, ``steps`` substeps; ``cloth_work``) over the kernel's
traced device time, in %."""

from port_bench.metrics.cloth_work import cloth_call_s
from port_bench.metrics.common import kernel_us, roofline_pct

KERNEL = r"tiled_kernel<\w+, \w+, true>"


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    h, wd = w["grid"]
    n, chunk = w["worlds"], w["chunk"]
    sizes = [chunk] * (n // chunk) + ([n % chunk] if n % chunk else [])
    bound = tr.units * sum(cloth_call_s(h, wd, b, w["steps"]) for b in sizes)
    return roofline_pct(bound, kernel_us(tr, KERNEL))
