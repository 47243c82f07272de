"""K1's share of its roofline (``ops/cloth_kernel.py`` → ``cloth_step.cu``
``substep_kernel``, a launch a substep: the scene's steps, and in the
gradient cell the forward's segments and the backward's trace): the bound
of one substep (``cloth_work``, one substep a call) times the traced
launches, over the kernel's traced device time, in %. One reader for
``k1_roofline.sim`` and ``k1_roofline.grad``, split by the end-to-end
metric that each cell reports."""

import re

from port_bench.metrics.cloth_work import cloth_call_s
from port_bench.metrics.common import roofline_pct

KERNEL = re.compile(r"substep_kernel<")


def read(ctx):
    tr, w = ctx["trace"], ctx["work"]
    h, wd = w["grid"]
    ops = [o for o in tr.ops if KERNEL.search(o.name)]
    bound = len(ops) * cloth_call_s(h, wd, 1, 1)
    return roofline_pct(bound, sum(o.dur for o in ops))
