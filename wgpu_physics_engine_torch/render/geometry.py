"""Static scene geometry in NumPy (the port's copy of what it needs from
``wgpu_physics_engine_tpu/render/geometry.py``)."""

from __future__ import annotations

import numpy as np


def wireframe_box(half_extent: float) -> np.ndarray:
    """12-edge line list ``[24, 3]`` for the simulation bounds box
    (instance.rs:145-166)."""
    b = half_extent
    corners = np.array([
        [-b, -b, -b], [b, -b, -b], [b, b, -b], [-b, b, -b],
        [-b, -b, b], [b, -b, b], [b, b, b], [-b, b, b],
    ], np.float32)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0),
             (4, 5), (5, 6), (6, 7), (7, 4),
             (0, 4), (1, 5), (2, 6), (3, 7)]
    return corners[np.array(edges).reshape(-1)]
