"""Host µs a kernel launch in ``cloth.issue`` (``ops/cloth_kernel.py``
``multi_step_launch_packed`` and ``trace_kernel``: the input checks, the
buffers and the C call that enqueues a call's K1 launches): the spans' host
time over the launches made inside them on their thread. Against K1's
device time a launch it says whether the host keeps up. One reader for
``k1.issue_us_per_launch.<variant>``."""

from port_bench.metrics.spans import host_us_per_launch


def read(ctx):
    return host_us_per_launch(ctx, "cloth.issue")
