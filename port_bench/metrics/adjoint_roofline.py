"""The cloth adjoint's share of its roofline (``ops/cloth_grad_kernel.py``
→ ``cloth_grad.cu``: ``vjp_substep``, a launch a substep, and the
``reduce_partials`` that sums its parameter partials): the bound of one
adjoint substep (``cloth_work``) times the traced ``vjp_substep`` launches,
over the traced device time of both kernels, in %."""

import re

from port_bench.metrics.cloth_work import adjoint_substep_s
from port_bench.metrics.common import kernel_us, roofline_pct

STEP = re.compile(r"vjp_substep")


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    h, wd = w["grid"]
    n = sum(1 for o in tr.ops if STEP.search(o.name))
    return roofline_pct(n * adjoint_substep_s(h, wd),
                        kernel_us(tr, r"vjp_substep|reduce_partials"))
