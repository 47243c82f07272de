"""Plain PyTorch reference of the cloth substep: a frozen copy of the
mass-spring step of the upstream engine (forces.wgsl:143-313,
compute_movement.wgsl:70-174), written as elementwise ops on six planes
(x, y, z, vx, vy, vz).

The order of every floating-point op is the one the engine's CUDA kernels
use (spring families in a fixed order, +E on the anchor then -E on the
other end; gravity, contact, friction, Euler and damping, projection), so
on one device a float32 run can equal the kernels to the last bit. It
imports nothing of the program: its parameters are worked out here from
the configuration's constants and the seeded per-world scales.

``dtype`` selects the precision: float32 as the configuration states, or
bfloat16 for the control that must fail the comparison.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

EPS = 1e-6

# Spring families (dr, dc, kind): structural right, down; shear down-right,
# down-left; bend 2-right, 2-down.
FAMILIES = ((0, 1, 0), (1, 0, 0), (1, 1, 1), (1, -1, 1), (0, 2, 2), (2, 0, 2))

# Packed parameter columns.
PARAM_NAMES = ("k_struct", "k_shear", "k_bend", "c_struct", "c_shear",
               "c_bend", "rest_struct", "rest_shear", "rest_bend",
               "k_contact", "mu", "mass", "gravity", "damp_factor",
               "min_dist", "dt")


def base_params(cloth: Dict) -> Dict[str, float]:
    """The per-world constants of a cloth configuration (``cloth`` as in the
    configuration file): rest lengths from the spacing ``size / (n - 1)``."""
    spacing = cloth["cloth_size"] / (cloth["particles_per_side"] - 1.0)
    return {
        "k_struct": cloth["k_struct"], "k_shear": cloth["k_shear"],
        "k_bend": cloth["k_bend"], "c_struct": cloth["c_struct"],
        "c_shear": cloth["c_shear"], "c_bend": cloth["c_bend"],
        "rest_struct": spacing, "rest_shear": spacing * math.sqrt(2.0),
        "rest_bend": spacing * 2.0, "k_contact": cloth["k_contact"],
        "mu": cloth["mu"], "mass": cloth["mass"], "gravity": cloth["gravity"],
        "speed_damp": cloth["speed_damp"],
        "globe_radius": cloth["globe_radius"],
        "particle_radius": cloth["particle_radius"],
    }


def pack(cloth: Dict, dt: float, device, stiffness_scale=None,
         gravity=None) -> torch.Tensor:
    """The ``[16]`` float32 parameter vector of :data:`PARAM_NAMES` (``[B,
    16]`` for ``[B]`` stiffness scales): each stiffness times its world's
    scale in float32, ``speed_damp ** dt`` and ``globe_radius +
    particle_radius`` in float32. ``gravity`` (a 0-d tensor) overrides the
    configuration's."""
    p = base_params(cloth)
    f32 = torch.float32

    def t(v):
        return torch.as_tensor(v, dtype=f32, device=device)

    dt_t = t(dt)
    cols = [t(p[k]) for k in PARAM_NAMES[:13]]
    if gravity is not None:
        cols[12] = gravity.to(f32)
    if stiffness_scale is not None:
        s = stiffness_scale.to(device=device, dtype=f32)
        cols[0], cols[1], cols[2] = cols[0] * s, cols[1] * s, cols[2] * s
    cols += [torch.pow(t(p["speed_damp"]), dt_t),
             t(p["globe_radius"]) + t(p["particle_radius"]), dt_t]
    return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


def init_grid(cloth: Dict, device) -> torch.Tensor:
    """The flat sheet the engine spawns (cloth.rs:848-893): row r → x, col
    c → z, ``(i - n/2) * spacing`` about the centre, at the centre's
    height; ``[3, n, n]`` float32."""
    n = cloth["particles_per_side"]
    f32 = torch.float32
    spacing = torch.tensor(cloth["cloth_size"] / (n - 1.0), dtype=f32,
                           device=device)
    cx, cy, cz = cloth["center"]
    r = torch.arange(n, dtype=f32, device=device)[:, None]
    c = torch.arange(n, dtype=f32, device=device)[None, :]
    x = (r - n / 2.0) * spacing + torch.tensor(cx, dtype=f32, device=device)
    z = (c - n / 2.0) * spacing + torch.tensor(cz, dtype=f32, device=device)
    return torch.stack([x.expand(n, n), torch.full((n, n), cy, dtype=f32,
                                                   device=device),
                        z.expand(n, n)])


def _shift(x, dr, dc):
    """result[..., r, c] = x[..., (r + dr) % h, (c + dc) % w]."""
    if dr:
        x = torch.roll(x, -dr, dims=-2)
    if dc:
        x = torch.roll(x, -dc, dims=-1)
    return x


def masks(h: int, w: int, device):
    """Per family, the anchors whose other end lies on the grid."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    out = []
    for dr, dc, _ in FAMILIES:
        ok = (rows < (h - dr)) & ((cols < (w - dc)) if dc >= 0
                                  else (cols >= -dc))
        out.append(ok.expand(h, w))
    return out


def _dist_inv(d2):
    """(|d|, 1/|d|), both 0 where |d| < EPS."""
    nonzero = d2 != 0
    dist = torch.where(nonzero, torch.sqrt(torch.where(nonzero, d2, 1.0)),
                       0.0)
    safe = dist >= EPS
    inv = torch.where(safe, 1.0 / torch.where(safe, dist, 1.0), 0.0)
    return dist, inv


def substep(carry: Sequence[torch.Tensor], fam_masks, prm):
    """One substep of six planes; ``prm`` the 16 parameters as tensors
    that broadcast against a plane (0-d, or ``[B, 1, 1]``)."""
    x, y, z, vx, vy, vz = carry
    k, c, rest = prm[0:3], prm[3:6], prm[6:9]
    fx = torch.zeros_like(x)
    fy = torch.zeros_like(x)
    fz = torch.zeros_like(x)
    for ok, (dr, dc, t) in zip(fam_masks, FAMILIES):
        p1x, p1y, p1z, v1x, v1y, v1z = (_shift(a, dr, dc)
                                        for a in (x, y, z, vx, vy, vz))
        dxv, dyv, dzv = p1x - x, p1y - y, p1z - z
        dist, inv = _dist_inv(dxv * dxv + dyv * dyv + dzv * dzv)
        safe = dist >= EPS
        ux, uy, uz = dxv * inv, dyv * inv, dzv * inv
        stretch = dist - rest[t]
        v_along = (v1x - vx) * ux + (v1y - vy) * uy + (v1z - vz) * uz
        s = k[t] * stretch + c[t] * v_along
        keep = ok & safe
        ex = torch.where(keep, s * ux, 0.0)
        ey = torch.where(keep, s * uy, 0.0)
        ez = torch.where(keep, s * uz, 0.0)
        fx = fx + ex
        fy = fy + ey
        fz = fz + ez
        fx = fx - _shift(ex, -dr, -dc)
        fy = fy - _shift(ey, -dr, -dc)
        fz = fz - _shift(ez, -dr, -dc)

    k_contact, mu, mass, gravity = prm[9], prm[10], prm[11], prm[12]
    damp, min_dist, dt = prm[13], prm[14], prm[15]
    fy = fy + mass * gravity
    dist, inv_d = _dist_inv(x * x + y * y + z * z)
    contact = (dist < min_dist) & (dist > EPS)
    nx, ny, nz = x * inv_d, y * inv_d, z * inv_d
    pen = k_contact * (min_dist - dist)
    fx = torch.where(contact, fx + pen * nx, fx)
    fy = torch.where(contact, fy + pen * ny, fy)
    fz = torch.where(contact, fz + pen * nz, fz)
    ro_n = fx * nx + fy * ny + fz * nz
    tx, ty, tz = fx - ro_n * nx, fy - ro_n * ny, fz - ro_n * nz
    tmag, inv_t = _dist_inv(tx * tx + ty * ty + tz * tz)
    fric = contact & (tmag > EPS)
    fmag = -torch.minimum(tmag, mu * torch.abs(ro_n))
    fx = torch.where(fric, fx + fmag * tx * inv_t, fx)
    fy = torch.where(fric, fy + fmag * ty * inv_t, fy)
    fz = torch.where(fric, fz + fmag * tz * inv_t, fz)

    inv_m = 1.0 / mass
    vx = (vx + fx * inv_m * dt) * damp
    vy = (vy + fy * inv_m * dt) * damp
    vz = (vz + fz * inv_m * dt) * damp
    x = x + vx * dt
    y = y + vy * dt
    z = z + vz * dt
    fdist, inv_f = _dist_inv(x * x + y * y + z * z)
    inside = fdist < min_dist
    on = inside & (fdist > EPS)
    centre = inside & ~on
    x = torch.where(on, x * inv_f * min_dist, torch.where(centre, 0.0, x))
    y = torch.where(on, y * inv_f * min_dist,
                    torch.where(centre, min_dist, y))
    z = torch.where(on, z * inv_f * min_dist, torch.where(centre, 0.0, z))
    vx = torch.where(inside, 0.0, vx)
    vy = torch.where(inside, 0.0, vy)
    vz = torch.where(inside, 0.0, vz)
    return x, y, z, vx, vy, vz


def plane_params(prm: torch.Tensor, dtype):
    """A ``[16]`` vector as 16 0-d tensors, a ``[B, 16]`` one as 16 ``[B,
    1, 1]`` tensors, in ``dtype``."""
    prm = prm.to(dtype)
    if prm.ndim == 1:
        return prm.unbind(0)
    return prm[:, :, None, None].unbind(1)


def multi_step(pos: torch.Tensor, vel: torch.Tensor, prm: torch.Tensor,
               n_steps: int, dtype=torch.float32,
               graph_steps: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_steps`` substeps of one world (``[3, H, W]``, ``prm`` ``[16]``)
    or a batch (``[B, 3, H, W]``, ``prm`` ``[B, 16]``), computed in
    ``dtype``; returns float32 ``(pos, vel)``.

    On a CUDA device ``graph_steps`` replays a CUDA graph of that many
    substeps (the same ops, without the host's cost of issuing each)."""
    h, w = pos.shape[-2:]
    fam = masks(h, w, pos.device)
    p = plane_params(prm, dtype)
    carry = tuple(a.to(dtype) for a in (*pos.unbind(-3), *vel.unbind(-3)))
    if graph_steps and pos.is_cuda and n_steps >= graph_steps:
        carry = _graphed(carry, fam, p, n_steps, graph_steps)
    else:
        for _ in range(n_steps):
            carry = substep(carry, fam, p)
    out = torch.stack(carry).to(torch.float32)
    return (out[:3].movedim(0, -3).contiguous(),
            out[3:].movedim(0, -3).contiguous())


def _graphed(carry, fam, p, n_steps: int, g: int):
    """``n_steps`` substeps: a CUDA graph of ``g`` substeps replayed, the
    remainder eagerly."""
    static = tuple(a.clone() for a in carry)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # warm the allocator up
        out = static
        for _ in range(g):
            out = substep(out, fam, p)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = static
        for _ in range(g):
            out = substep(out, fam, p)
    for s, a in zip(static, carry):
        s.copy_(a)
    n_rep, rem = divmod(n_steps, g)
    for i in range(n_rep):
        graph.replay()
        if i + 1 < n_rep:
            for s, o in zip(static, out):
                s.copy_(o)
    carry = tuple(o.clone() for o in out)
    del graph
    for _ in range(rem):
        carry = substep(carry, fam, p)
    return carry
