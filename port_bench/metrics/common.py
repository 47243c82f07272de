"""What the per-layer metric readers share: device time of the traced
kernels whose names match a pattern, and device time by program range."""

from __future__ import annotations

import re


def kernel_us(tr, pattern: str) -> float:
    """Device µs of the traced operations whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(o.dur for o in tr.ops if rx.search(o.name))


def owned_us(tr, owner: str, exclude: str = None) -> float:
    """Device µs of the operations launched inside program range
    ``owner``, less those whose name matches ``exclude``."""
    rx = re.compile(exclude) if exclude else None
    return sum(o.dur for o in tr.ops if o.owner == owner
               and not (rx and rx.search(o.name)))


def roofline_pct(bound_s: float, device_us: float):
    """``bound_s`` over the traced device time, in %; nothing when the
    kernels did not run in the traced units."""
    if device_us <= 0:
        return None
    return 100.0 * bound_s / (device_us * 1e-6)


def idle_share(tr) -> float:
    """1 - the union of device spans over the traced window."""
    return 1.0 - tr.busy_us / tr.window_us
