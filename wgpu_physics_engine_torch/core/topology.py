"""Spring topology builder (edge lists) for H×W cloth grids.

Reproduces ``generate_spring_lists`` (``5_cloth_simulation/src/cloth.rs:907-962``)
exactly: iterate rows r, cols c, particle index ``i = r*W + c``;

* structural: right ``(i, i+1)`` and down ``(i, i+W)``             (cloth.rs:945-946)
* shear:      down-right ``(i, i+W+1)`` and down-left ``(i, (r+1)*W + c-1)``
              — the down-left pair is emitted only when ``q > p`` is
              canonicalizable; ``push_unique`` drops ``q < p`` pairs, and for
              down-left q = i+W-1 > i always, so all are kept (cloth.rs:948-954)
* bend:       two-right ``(i, i+2)`` and two-down ``(i, i+2W)``    (cloth.rs:956-957)

Counts for an n×n grid: structural ``2n(n-1)``, shear ``2(n-1)^2``,
bend ``2n(n-2)`` — 60×60 → 7080 + 6962 + 6960 = 21002 springs.

The per-spring rest length computed from initial positions is stored in
``prev_length`` (cloth.rs:922-939) but the force kernel uses the *uniform*
rest lengths from PhysicsConstants (forces.wgsl:167,207,244); we carry both.

This edge-list path exists for arbitrary (non-grid) topologies and for the
spring-count label of ``ClothScene``; stepping uses the equivalent stencil
formulation in :mod:`wgpu_physics_engine_torch.models.cloth`. NumPy only: a
copy of ``wgpu_physics_engine_tpu/core/topology.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SpringLists(NamedTuple):
    """Three edge lists, each ``(p0[i], p1[i])`` with ``p0 < p1`` and
    ``rest0[i]`` = geometric rest length from initial positions."""

    struct_p0: np.ndarray
    struct_p1: np.ndarray
    struct_rest0: np.ndarray
    shear_p0: np.ndarray
    shear_p1: np.ndarray
    shear_rest0: np.ndarray
    bend_p0: np.ndarray
    bend_p1: np.ndarray
    bend_rest0: np.ndarray


def spring_counts(height: int, width: int) -> tuple[int, int, int]:
    """Closed-form spring counts (structural, shear, bend) for an H×W grid."""
    structural = height * (width - 1) + (height - 1) * width
    shear = 2 * (height - 1) * (width - 1)
    bend = height * max(width - 2, 0) + max(height - 2, 0) * width
    return structural, shear, bend


def build_spring_lists(positions: np.ndarray, height: int, width: int) -> SpringLists:
    """Build the three spring edge lists in the reference's emission order.

    ``positions``: float32 ``[H*W, 3]`` initial particle positions (row-major
    ``i = r*W + c``), used only for the geometric rest lengths.
    """
    assert positions.shape == (height * width, 3)
    pos = positions.astype(np.float32)

    struct_pairs: list[tuple[int, int]] = []
    shear_pairs: list[tuple[int, int]] = []
    bend_pairs: list[tuple[int, int]] = []

    for r in range(height):
        for c in range(width):
            i = r * width + c
            if c + 1 < width:
                struct_pairs.append((i, i + 1))
            if r + 1 < height:
                struct_pairs.append((i, i + width))
            if r + 1 < height and c + 1 < width:
                shear_pairs.append((i, i + width + 1))
            if r + 1 < height and c >= 1:
                shear_pairs.append((i, (r + 1) * width + (c - 1)))
            if c + 2 < width:
                bend_pairs.append((i, i + 2))
            if r + 2 < height:
                bend_pairs.append((i, i + 2 * width))

    def pack(pairs):
        if not pairs:
            z = np.zeros((0,), np.int32)
            return z, z.copy(), np.zeros((0,), np.float32)
        a = np.asarray(pairs, np.int32)
        p0, p1 = a[:, 0], a[:, 1]
        d = pos[p1] - pos[p0]
        rest = np.sqrt((d * d).sum(axis=1)).astype(np.float32)
        return p0, p1, rest

    sp0, sp1, sr = pack(struct_pairs)
    hp0, hp1, hr = pack(shear_pairs)
    bp0, bp1, br = pack(bend_pairs)
    return SpringLists(sp0, sp1, sr, hp0, hp1, hr, bp0, bp1, br)
