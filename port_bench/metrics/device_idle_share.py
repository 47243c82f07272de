"""The device's idle share over the traced units: 1 - the union of the
spans of every device operation launched in them over the traced window
(the host's clock, from the first unit's start to the last operation's
end). One reader for ``device_idle_share.<variant>``, the variants split
by the end-to-end metric that each cell reports."""

from port_bench.metrics.common import idle_share


def read(ctx):
    return idle_share(ctx["trace"])
