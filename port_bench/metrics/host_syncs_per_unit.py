"""Synchronising CUDA runtime calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, a blocking
``cudaMemcpy``) made inside a program span, a unit: each drains the queue
the device works from. One reader for ``host_syncs_per_unit.<variant>``."""

from port_bench.metrics.spans import syncs_per_unit


def read(ctx):
    return syncs_per_unit(ctx)
