"""Device idle ms a unit with no program span active on any thread: the
cell's ``drivers/`` module (its copy and sync), autograd's engine between
segments, Python between the program's calls. One reader for
``idle_outside_program_ms_per_unit.<variant>``, the variants split by the
end-to-end metric that each cell reports."""

from port_bench.metrics.spans import idle_ms_per_unit


def read(ctx):
    return idle_ms_per_unit(ctx, None)
