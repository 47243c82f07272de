"""Host-side scene geometry in NumPy (the port's copy of
``wgpu_physics_engine_tpu/render/geometry.py``; the same arrays bit for
bit).

* :func:`generate_uv_sphere` — parametric UV sphere with the vertex and
  index layout of the reference's generator
  (``simulations/3_Globe/src/sphere_vertices.rs:21-82``):
  ``(stacks+1) × (sectors+1)`` vertices with pos/normal/uv, CCW triangles,
  one triangle per sector at the poles.
* :func:`cube_mesh` — 24-vertex/36-index cube with per-face normals, uv
  and colors (``1_Cube/src/cube_app.rs:42-154``,
  ``2_TexturedCube/src/textured_cube_app.rs:68-109``).
* :func:`wireframe_box` — line-list box for the free-particle bounds
  (``4_instances_imgui/src/instance.rs:145-166``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Mesh(NamedTuple):
    """Indexed triangle mesh, host-side float32/int32 arrays."""

    positions: np.ndarray   # [V, 3]
    normals: np.ndarray     # [V, 3]
    uvs: np.ndarray         # [V, 2]
    indices: np.ndarray     # [I] int32, triangle list
    colors: Optional[np.ndarray] = None  # [V, 3] optional per-vertex color


def generate_uv_sphere(radius: float, stack_count: int, sector_count: int) -> Mesh:
    """UV sphere with the reference's parametrization: polar axis = +z,
    stack angle from +π/2 (north) to −π/2, sector angle 0..2π around z.

    Vertex (i, j): ``(r·cosφ·cosθ, r·cosφ·sinθ, r·sinφ)`` with
    ``φ = π/2 − i·π/stacks``, ``θ = j·2π/sectors``;
    ``uv = (j/sectors, i/stacks)``.
    """
    st = np.arange(stack_count + 1, dtype=np.float32)
    se = np.arange(sector_count + 1, dtype=np.float32)
    phi = np.float32(np.pi / 2) - st * np.float32(np.pi / stack_count)   # [S+1]
    theta = se * np.float32(2 * np.pi / sector_count)                    # [C+1]

    cos_phi = np.cos(phi)[:, None]
    sin_phi = np.sin(phi)[:, None]
    x = radius * cos_phi * np.cos(theta)[None, :]
    y = radius * cos_phi * np.sin(theta)[None, :]
    z = radius * sin_phi * np.ones_like(theta)[None, :]
    pos = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)

    lens = np.linalg.norm(pos, axis=1, keepdims=True)
    normals = np.where(lens > 0, pos / np.where(lens > 0, lens, 1.0),
                       np.array([0.0, 1.0, 0.0], np.float32))
    u = (se / sector_count).astype(np.float32)
    v = (st / stack_count).astype(np.float32)
    uvs = np.stack(np.broadcast_arrays(u[None, :], v[:, None]), axis=-1)
    uvs = uvs.reshape(-1, 2).astype(np.float32)

    # indices: quad (i, j) spans rows i/i+1; skip degenerate pole triangles
    i = np.arange(stack_count)[:, None]
    j = np.arange(sector_count)[None, :]
    k1 = i * (sector_count + 1) + j
    k2 = k1 + (sector_count + 1)
    a, b, c, d = k1, k2, k1 + 1, k2 + 1
    # Emission order matches the reference: per (i, j), (a,b,c) unless at the
    # north pole row, then (c,b,d) unless at the south pole row.
    t1 = np.stack([a, b, c], axis=-1)   # [S, C, 3]
    t2 = np.stack([c, b, d], axis=-1)
    both = np.stack([t1, t2], axis=2)   # [S, C, 2, 3]
    mask = np.ones((stack_count, sector_count, 2), bool)
    mask[0, :, 0] = False
    mask[-1, :, 1] = False
    indices = both[mask].reshape(-1, 3).astype(np.int32).reshape(-1)

    return Mesh(pos, normals.astype(np.float32), uvs, indices)


_CUBE_FACES = (
    # normal, 4 corner positions (CCW seen from outside), for a unit cube
    (( 0,  0,  1), ((-1, -1,  1), ( 1, -1,  1), ( 1,  1,  1), (-1,  1,  1))),
    (( 0,  0, -1), (( 1, -1, -1), (-1, -1, -1), (-1,  1, -1), ( 1,  1, -1))),
    (( 1,  0,  0), (( 1, -1,  1), ( 1, -1, -1), ( 1,  1, -1), ( 1,  1,  1))),
    ((-1,  0,  0), ((-1, -1, -1), (-1, -1,  1), (-1,  1,  1), (-1,  1, -1))),
    (( 0,  1,  0), ((-1,  1,  1), ( 1,  1,  1), ( 1,  1, -1), (-1,  1, -1))),
    (( 0, -1,  0), ((-1, -1, -1), ( 1, -1, -1), ( 1, -1,  1), (-1, -1,  1))),
)

_FACE_COLORS = np.array([
    [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1],
], np.float32)


def cube_mesh(half_extent: float = 1.0) -> Mesh:
    """24-vertex cube (4 per face, so normals/uv are per-face), 36 indices,
    with per-face colors for the flat-color cube app (C3)."""
    positions, normals, uvs, colors, indices = [], [], [], [], []
    uv_quad = [(0, 1), (1, 1), (1, 0), (0, 0)]
    for f, (n, corners) in enumerate(_CUBE_FACES):
        base = len(positions)
        for corner, uv in zip(corners, uv_quad):
            positions.append([cc * half_extent for cc in corner])
            normals.append(n)
            uvs.append(uv)
            colors.append(_FACE_COLORS[f])
        indices += [base, base + 1, base + 2, base, base + 2, base + 3]
    return Mesh(
        np.asarray(positions, np.float32),
        np.asarray(normals, np.float32),
        np.asarray(uvs, np.float32),
        np.asarray(indices, np.int32),
        np.asarray(colors, np.float32),
    )


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
