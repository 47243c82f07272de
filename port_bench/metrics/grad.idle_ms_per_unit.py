"""Device idle ms a unit of the training loop's gradient
(``ops/cloth_grad_kernel.py``: ``grad.forward`` around the segments of
``multi_step_diff``, ``grad.segment.forward`` and ``.backward`` a segment,
``grad.adjoint.issue``): idle whose innermost program span is a ``grad.*``
span or a ``cloth.*`` span inside one."""

from port_bench.metrics.spans import idle_ms_per_unit, within


def read(ctx):
    return idle_ms_per_unit(ctx, within(("grad.",)))
