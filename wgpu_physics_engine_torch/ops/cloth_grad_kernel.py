"""Reverse-mode differentiation through the fused cloth substeps: the
adjoint of one substep as a CUDA kernel, its plain torch version, and the
segment-checkpointed ``torch.autograd.Function`` around them.

The counterpart of ``wgpu_physics_engine_tpu/ops/cloth_pallas_grad.py``
(kernels K7, K8 and K9):

* **primal** — segments of ``segment`` substeps run the unmodified stepper
  (``cloth_kernel.multi_step``: K1 on a CUDA state), so the output equals
  the plain forward bit for bit;
* **backward, per segment in reverse** — :func:`cloth_kernel.trace` re-runs
  the segment from its saved start state with the same stepper and keeps
  each substep's input state (``[K, 6, H, W]``); the walk then goes
  through it backwards with :func:`substep_vjp`, carrying the state
  cotangent and accumulating the 16 parameter cotangents and the pin
  cotangents.

:func:`substep_vjp_plain` is the adjoint written by hand on planes, in the
op order of ``csrc/cloth_grad.cu``; it is not ``torch.autograd`` of the
forward, so the CPU tests check the derivation the kernel carries against
autograd of the transcribed pure functions :func:`_family_force` and
:func:`_integrate_planes` (and against ``jax.grad``). For a spring edge
``a → b`` with ``d = x_b − x_a``, ``L = |d|``, ``u = d/L``,
``Δv = v_b − v_a``, ``s = k(L − rest) + c Δv·u`` and force ``E = s u`` (kept
where the edge is valid and ``L ≥ EPS``), the cotangent ``Ē = ctf[a] −
ctf[b]`` of the force gives, with ``s̄ = Ē·u``::

    d̄  = s̄ k u + (I − u uᵀ)(s̄ c Δv + s Ē)/L;   x̄_b += d̄,  x̄_a −= d̄
    Δv̄ = s̄ c u;                                v̄_b += Δv̄, v̄_a −= Δv̄
    k̄ += s̄ (L − rest),  c̄ += s̄ Δv·u,  rest̄ −= s̄ k

Branches (contact, friction and its ``min``, projection, pins)
differentiate in the same almost-everywhere, where-guarded sense as the
JAX package; a tie in the Coulomb ``min`` splits its cotangent in half,
as ``torch.minimum`` and ``jax.lax.min`` do.

There is no size limit and no alignment condition on ``n_steps`` or the
grid: the TPU's three tiers (whole-plane, banded, streamed) were VMEM
facts, and one adjoint kernel takes every grid. It runs one launch a
substep on tiles of :data:`TILE` particles: each CTA stages the state over
its tile grown by 4 in shared memory, recomputes the integration adjoint
on the tile grown by 2 and keeps the force cotangent there, and evaluates
each edge force and edge adjoint once. :func:`substep_vjp_tiled` is the
same decomposition in torch (``_substep_vjp_planes`` on halo-extended
tiles, the core cells kept), which the CPU tests hold against
:func:`substep_vjp_plain` for the halo argument the kernel relies on.

The rows-sharded path (``parallel/mesh.py``) differentiates through its
windows the same way: :func:`multi_step_window` is K1w's (or K6w's)
forward on a batch of halo-extended row windows (every window one device
holds in an exchange block), and its backward re-runs them with
``cloth_kernel.trace_window`` and walks them with :func:`walk_window`, the
adjoint with K1w's global-row spring masks (:func:`_walk_window_plain`; on
CUDA the kernel's ``WINDOW`` instantiation, one launch a substep for the
batch). The plain version sums the batch's parameter cotangent in the
kernel's order (:func:`_kernel_order_partials`, :func:`_reduce_partials`),
so the two agree bit for bit on the card. JAX takes this gradient by XLA
autodiff of its window stencil (``parallel/mesh.py`` with
``use_kernel=False``), a window at a time; the port computes it by hand on
the card, as it does for the whole grid.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..core.state import ClothParams, ClothState
from . import _build, cloth_kernel
from .cloth_kernel import _EPS, _FAMILIES, _exact_dist_inv, _shift
from ..utils.profiling import span

# Launches of the substep adjoint (``csrc/cloth_grad.cu``), one per
# substep walked; a run reads it to show that its backward went through
# the kernel. LAUNCHES_WINDOW counts those of its window instantiation.
LAUNCHES = 0
LAUNCHES_WINDOW = 0

# The segment when the caller gives none: the backward keeps
# ``segment · 24 · H · W`` bytes of trajectory (100 MB at 256²).
DEFAULT_SEGMENT = 64

# The adjoint kernel's tile, (rows, columns) of particles, one row of
# parameter partials a tile (csrc/cloth_grad.cu kTileH, kTileW), and the
# threads of its CTA (kVjpThreads).
TILE = (16, 16)
THREADS = 256

_SIGNATURES = {
    "wpe_cloth_substep_vjp": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                             + [ctypes.c_void_p],
    "wpe_cloth_substep_vjp_window": [ctypes.c_void_p] * 8
                                    + [ctypes.c_int] * 5 + [ctypes.c_void_p]
                                    + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


# ---------------------------------------------------------------------------
# The pure substep functions (autograd reference for the hand adjoint)
# ---------------------------------------------------------------------------

def _family_force(x, y, z, vx, vy, vz, kk, cc, rr, *, dr, dc, ok):
    """One spring family's force planes, anchor and reaction together: the
    transcription of ``cloth_pallas_grad._family_force`` (gradient-safe
    norms). The six families' terms add up to the spring force."""
    p1x, p1y, p1z, v1x, v1y, v1z = (_shift(a, dr, dc)
                                    for a in (x, y, z, vx, vy, vz))
    dxv, dyv, dzv = p1x - x, p1y - y, p1z - z
    dist, inv = _exact_dist_inv(dxv * dxv + dyv * dyv + dzv * dzv)
    safe = dist >= _EPS
    ux, uy, uz = dxv * inv, dyv * inv, dzv * inv
    stretch = dist - rr
    v_along = (v1x - vx) * ux + (v1y - vy) * uy + (v1z - vz) * uz
    s = kk * stretch + cc * v_along
    keep = ok & safe
    ex = torch.where(keep, s * ux, 0.0)
    ey = torch.where(keep, s * uy, 0.0)
    ez = torch.where(keep, s * uz, 0.0)
    return (ex - _shift(ex, -dr, -dc), ey - _shift(ey, -dr, -dc),
            ez - _shift(ez, -dr, -dc))


def _integrate_planes(x, y, z, vx, vy, vz, fx, fy, fz, k_contact, mu, mass,
                      gravity, damp_factor, min_dist, dt, *pin_pos, pin=None):
    """Gravity → contact → friction → Euler + damping → projection → pins:
    ``cloth_pallas_grad._integrate_planes`` (the same expressions as the
    stepper's, with gradient-safe norms). ``pin_pos`` is ``(px, py, pz)``
    when ``pin`` is a mask plane."""
    prm = (None,) * 9 + (k_contact, mu, mass, gravity, damp_factor, min_dist,
                         dt)
    pins = None if pin is None else (pin, *pin_pos)
    return cloth_kernel._integrate_planes((x, y, z, vx, vy, vz), (fx, fy, fz),
                                          prm, _exact_dist_inv, pins)


# ---------------------------------------------------------------------------
# Plain version of the substep adjoint
# ---------------------------------------------------------------------------

def _substep_vjp_planes(state_in, ct_pos, ct_vel, prm, pins, masks=None,
                        count=None, terms=False):
    """The adjoint of one substep on planes; the parameter cotangent comes
    back as float64 sums of the fp32 per-particle and per-edge terms.
    ``masks`` are the families' validity planes (default: the whole grid's,
    ``cloth_kernel._family_masks``); ``count``, a boolean plane, limits the
    parameter sums to the terms of its cells (a cell's and the edges it
    anchors; default: all). With ``terms`` the parameter cotangent comes
    back unsummed, as the fp32 term planes of :func:`_kernel_order_partials`:
    the seven of each cell (parameters 9..15), then (k, c, rest) of the
    spring each family anchors at each cell, family by family."""
    h, w = state_in.shape[-2:]
    dev = state_in.device
    P = prm.detach().to(device=dev, dtype=torch.float32).unbind(0)
    k, c, rest = P[0:3], P[3:6], P[6:9]
    k_contact, mu, mass, gravity = P[9], P[10], P[11], P[12]
    damp, min_dist, dt = P[13], P[14], P[15]
    if masks is None:
        masks = cloth_kernel._family_masks(h, w, dev)

    def _sum64(plane):
        if count is not None:
            plane = torch.where(count, plane, 0.0)
        return plane.double().sum()

    carry = tuple(state_in.unbind(0))
    x, y, z, vx, vy, vz = carry
    where = torch.where

    # ---- forward of the integration, in the stepper's op order ----
    fx, fy, fz = cloth_kernel._spring_planes(carry, masks, P, _exact_dist_inv)
    fy = fy + mass * gravity
    dist, inv_d = _exact_dist_inv(x * x + y * y + z * z)
    in_contact = (dist < min_dist) & (dist > _EPS)
    nx, ny, nz = x * inv_d, y * inv_d, z * inv_d
    pen = k_contact * (min_dist - dist)
    f1x = where(in_contact, fx + pen * nx, fx)
    f1y = where(in_contact, fy + pen * ny, fy)
    f1z = where(in_contact, fz + pen * nz, fz)
    ro_n = f1x * nx + f1y * ny + f1z * nz
    tx, ty, tz = f1x - ro_n * nx, f1y - ro_n * ny, f1z - ro_n * nz
    tmag, inv_t = _exact_dist_inv(tx * tx + ty * ty + tz * tz)
    fric = in_contact & (tmag > _EPS)
    cap = mu * torch.abs(ro_n)
    fmag = -torch.minimum(tmag, cap)
    f2x = where(fric, f1x + fmag * tx * inv_t, f1x)
    f2y = where(fric, f1y + fmag * ty * inv_t, f1y)
    f2z = where(fric, f1z + fmag * tz * inv_t, f1z)
    inv_m = 1.0 / mass
    hx, hy, hz = f2x * inv_m, f2y * inv_m, f2z * inv_m
    ax, ay, az = vx + hx * dt, vy + hy * dt, vz + hz * dt
    v1x, v1y, v1z = ax * damp, ay * damp, az * damp
    x1, y1, z1 = x + v1x * dt, y + v1y * dt, z + v1z * dt
    fdist, inv_f = _exact_dist_inv(x1 * x1 + y1 * y1 + z1 * z1)
    pen2 = fdist < min_dist
    pen_safe = pen2 & (fdist > _EPS)
    pen_center = pen2 & ~pen_safe

    # ---- pins ----
    bx, by, bz = ct_pos.unbind(0)
    bvx, bvy, bvz = ct_vel.unbind(0)
    ct_pin = None
    if pins is not None:
        pin = pins[0] != 0
        ct_pin = torch.stack([where(pin, b, 0.0) for b in (bx, by, bz)])
        bx, by, bz, bvx, bvy, bvz = (where(pin, 0.0, b)
                                     for b in (bx, by, bz, bvx, bvy, bvz))

    # ---- projection ----
    bvx, bvy, bvz = (where(pen2, 0.0, b) for b in (bvx, bvy, bvz))
    ux, uy, uz = x1 * inv_f, y1 * inv_f, z1 * inv_f
    g_md = where(pen_safe, bx * ux + by * uy + bz * uz,
                 where(pen_center, by, 0.0))
    qx, qy, qz = bx * min_dist, by * min_dist, bz * min_dist
    uq = ux * qx + uy * qy + uz * qz
    b1x = where(pen_safe, (qx - ux * uq) * inv_f, where(pen_center, 0.0, bx))
    b1y = where(pen_safe, (qy - uy * uq) * inv_f, where(pen_center, 0.0, by))
    b1z = where(pen_safe, (qz - uz * uq) * inv_f, where(pen_center, 0.0, bz))

    # ---- Euler and damping ----
    bvx, bvy, bvz = bvx + b1x * dt, bvy + b1y * dt, bvz + b1z * dt
    g_dt = b1x * v1x + b1y * v1y + b1z * v1z
    abx, aby, abz = bvx * damp, bvy * damp, bvz * damp
    g_damp = bvx * ax + bvy * ay + bvz * az
    hbx, hby, hbz = abx * dt, aby * dt, abz * dt
    g_dt = g_dt + (abx * hx + aby * hy + abz * hz)
    fbx, fby, fbz = hbx * inv_m, hby * inv_m, hbz * inv_m
    g_inv_m = hbx * f2x + hby * f2y + hbz * f2z
    g_mass = -(g_inv_m * inv_m * inv_m)

    # ---- friction: f2 = f1 + fmag t / |t|, fmag = -min(|t|, mu |ro_n|) ----
    sdot = fbx * tx + fby * ty + fbz * tz
    m_b = -(sdot * inv_t)
    inv_t_b = fmag * sdot
    half = 0.5 * m_b
    tmag_b = where(tmag < cap, m_b, where(tmag > cap, 0.0, half))
    cap_b = where(tmag > cap, m_b, where(tmag < cap, 0.0, half))
    tmag_b = tmag_b - inv_t_b * inv_t * inv_t
    tbx = fbx * fmag * inv_t + tmag_b * tx * inv_t
    tby = fby * fmag * inv_t + tmag_b * ty * inv_t
    tbz = fbz * fmag * inv_t + tmag_b * tz * inv_t
    g_mu = where(fric, cap_b * torch.abs(ro_n), 0.0)
    ro_b = cap_b * mu * torch.sign(ro_n)
    ro_b = ro_b - (tbx * nx + tby * ny + tbz * nz)
    f1bx = where(fric, fbx + tbx + ro_b * nx, fbx)
    f1by = where(fric, fby + tby + ro_b * ny, fby)
    f1bz = where(fric, fbz + tbz + ro_b * nz, fbz)
    nbx = where(fric, -(ro_n * tbx) + ro_b * f1x, 0.0)
    nby = where(fric, -(ro_n * tby) + ro_b * f1y, 0.0)
    nbz = where(fric, -(ro_n * tbz) + ro_b * f1z, 0.0)

    # ---- contact: f1 = f0 + k_contact (min_dist - |x|) x / |x| ----
    pen_b = f1bx * nx + f1by * ny + f1bz * nz
    nbx, nby, nbz = nbx + pen * f1bx, nby + pen * f1by, nbz + pen * f1bz
    g_kc = where(in_contact, pen_b * (min_dist - dist), 0.0)
    g_md = g_md + where(in_contact, pen_b * k_contact, 0.0)
    dist_b = -(pen_b * k_contact) - (nbx * x + nby * y + nbz * z) * inv_d * inv_d
    cx = b1x + where(in_contact, nbx * inv_d + dist_b * nx, 0.0)
    cy = b1y + where(in_contact, nby * inv_d + dist_b * ny, 0.0)
    cz = b1z + where(in_contact, nbz * inv_d + dist_b * nz, 0.0)

    # ---- gravity; the spring force's cotangent is the contact input's ----
    ctfx, ctfy, ctfz = f1bx, f1by, f1bz
    g_mass = g_mass + ctfy * gravity
    g_grav = ctfy * mass
    cvx, cvy, cvz = abx, aby, abz

    # ---- springs, gathered per family as csrc/cloth_grad.cu does ----
    g = torch.zeros(16, dtype=torch.float64, device=dev)
    edge_terms = []
    for fam_idx, (dr, dc, t) in enumerate(_FAMILIES):
        p1x, p1y, p1z, v1x_, v1y_, v1z_ = (_shift(a, dr, dc) for a in carry)
        dxv, dyv, dzv = p1x - x, p1y - y, p1z - z
        el, inv = _exact_dist_inv(dxv * dxv + dyv * dyv + dzv * dzv)
        keep = masks[fam_idx] & (el >= _EPS)
        ux, uy, uz = dxv * inv, dyv * inv, dzv * inv
        stretch = el - rest[t]
        dvx, dvy, dvz = v1x_ - vx, v1y_ - vy, v1z_ - vz
        v_along = dvx * ux + dvy * uy + dvz * uz
        s = k[t] * stretch + c[t] * v_along
        ebx = ctfx - _shift(ctfx, dr, dc)          # Ē = ctf[a] - ctf[b]
        eby = ctfy - _shift(ctfy, dr, dc)
        ebz = ctfz - _shift(ctfz, dr, dc)
        sb = ebx * ux + eby * uy + ebz * uz
        sc = sb * c[t]
        ubx, uby, ubz = s * ebx + sc * dvx, s * eby + sc * dvy, s * ebz + sc * dvz
        ud = ubx * dxv + uby * dyv + ubz * dzv
        lb = sb * k[t] - ud * inv * inv
        dbs = [where(keep, ub * inv + lb * u, 0.0)
               for ub, u in ((ubx, ux), (uby, uy), (ubz, uz))]
        dvbs = [where(keep, sc * u, 0.0) for u in (ux, uy, uz)]
        gk = where(keep, sb * stretch, 0.0)
        gc = where(keep, sb * v_along, 0.0)
        grest = where(keep, -(sb * k[t]), 0.0)
        if terms:
            edge_terms += [gk, gc, grest]
        else:
            g[t] += _sum64(gk)
            g[3 + t] += _sum64(gc)
            g[6 + t] += _sum64(grest)
        cx, cy, cz = (a - d for a, d in zip((cx, cy, cz), dbs))
        cx, cy, cz = (a + _shift(d, -dr, -dc) for a, d in zip((cx, cy, cz), dbs))
        cvx, cvy, cvz = (a - d for a, d in zip((cvx, cvy, cvz), dvbs))
        cvx, cvy, cvz = (a + _shift(d, -dr, -dc)
                         for a, d in zip((cvx, cvy, cvz), dvbs))

    cells = (g_kc, g_mu, g_mass, g_grav, g_damp, g_md, g_dt)
    if terms:
        g = torch.stack([torch.broadcast_to(a, x.shape)
                         for a in cells + tuple(edge_terms)])
    else:
        for j, plane in enumerate(cells):
            g[9 + j] = _sum64(plane)
    return (torch.stack([cx, cy, cz]), torch.stack([cvx, cvy, cvz]), g,
            ct_pin)


def substep_vjp_plain(state_in: torch.Tensor, ct_pos: torch.Tensor,
                      ct_vel: torch.Tensor, prm: torch.Tensor, pins=None):
    """The adjoint of one exact substep of one world, by hand, on any
    device.

    ``state_in`` is the state entering the substep, ``[6, H, W]`` (x, y,
    z, vx, vy, vz); ``ct_pos``/``ct_vel`` ``[3, H, W]`` the cotangent of its
    output; ``prm`` the packed ``[16]`` vector of
    ``cloth_kernel._pack_params``; ``pins`` ``(pin_mask [H, W], pin_pos
    [3, H, W])`` or None. Returns the cotangents of pos and vel entering
    the substep, the substep's ``[16]`` parameter cotangent (each entry a
    float64 sum of its fp32 terms, rounded once), and the ``pin_pos``
    cotangent (None without pins)."""
    cp, cv, g, ct_pin = _substep_vjp_planes(state_in, ct_pos, ct_vel, prm,
                                            pins)
    return cp, cv, g.float(), ct_pin


def substep_vjp_window_plain(state_in: torch.Tensor, ct_pos: torch.Tensor,
                             ct_vel: torch.Tensor, prm: torch.Tensor,
                             row0, h_global: int, pins=None):
    """:func:`substep_vjp_plain` for one substep of K1w on a row window
    ``[6, h, W]`` whose local row 0 is global row ``row0`` of a grid
    ``h_global`` rows high (or on a batch ``[B, 6, h, W]`` with B first
    rows): the springs masked by ``cloth_kernel._window_masks``, the walk
    of one substep of :func:`_walk_window_plain`. Every cell of the window
    counts in the parameter cotangent; a dead row (beyond the grid) joins
    no spring, so its terms are 0 where its incoming cotangent is."""
    return _walk_window_plain(state_in[None], ct_pos, ct_vel, prm, pins,
                              row0, h_global)


def _walk_plain(traj, ct_pos, ct_vel, prm, pins, window=None):
    """Substeps ``traj.shape[0] - 1 .. 0`` of :func:`substep_vjp_plain`:
    the state cotangent carried, the parameter cotangent summed in float64
    and rounded once, the pin cotangent summed in fp32 in walk order (as
    the kernel does). With ``window = (row0, h_global)``
    :func:`_walk_window_plain`."""
    if window is not None:
        return _walk_window_plain(traj, ct_pos, ct_vel, prm, pins, *window)
    g = torch.zeros(16, dtype=torch.float64, device=traj.device)
    ct_pin = (torch.zeros_like(ct_pos) if pins is not None else None)
    for s in range(traj.shape[0] - 1, -1, -1):
        ct_pos, ct_vel, gs, gp = _substep_vjp_planes(traj[s], ct_pos, ct_vel,
                                                     prm, pins)
        g = g + gs
        if gp is not None:
            ct_pin = ct_pin + gp
    return ct_pos, ct_vel, g.float(), ct_pin


def _thread_maps():
    """For the kernel's two loops over a tile's regions, the core cell
    (row-major in the tile, -1 for none) that thread t takes at pass i,
    ``[passes, THREADS]``: the integration's loop over the core grown by
    2 (step 1b; a cell counts in the core) and the spring adjoints' over
    their anchors (step 2a; an anchor counts in the core)."""
    th, tw = TILE

    def region(rows, cols, y0, x0):
        n = rows * cols
        passes = -(-n // THREADS)
        j = torch.arange(passes * THREADS)
        y, x = j // cols - y0, j % cols - x0
        core = (j < n) & (y >= 0) & (y < th) & (x >= 0) & (x < tw)
        return torch.where(core, y * tw + x, -1).view(passes, THREADS)

    return region(th + 4, tw + 4, 2, 2), region(th + 2, tw + 3, 2, 2)


def _ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """The float64 sum over the leading axis from 0.0, one term after the
    other."""
    acc = torch.zeros_like(x[0])
    for a in x:
        acc = acc + a
    return acc


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """``cloth_grad.cu``'s ``block_sum`` over the last axis (the CTA's
    threads): a shuffle-down tree in each warp of 32, then the warps in
    order."""
    v = v.unflatten(-1, (-1, 32))
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return _ordered_sum(v[..., 0].movedim(-1, 0))


def _kernel_order_partials(terms: torch.Tensor) -> torch.Tensor:
    """One substep's parameter partials of ``csrc/cloth_grad.cu`` from the
    term planes of :func:`_substep_vjp_planes` (``terms=True``, ``[25, B,
    h, w]``): float64 ``[B · tiles, 16]``, window b's tiles after window
    b - 1's, each row summed as the tile's CTA sums it. Each thread adds
    the terms of its cells (integration) and anchors (springs, the two
    families of a type in order) in the order of its loops, skipping
    nothing but zeros, which change no float64 sum that started at 0.0;
    then :func:`_block_sum`."""
    th, tw = TILE
    n, b, h, w = terms.shape
    ty, tx = -(-h // th), -(-w // tw)
    t = torch.nn.functional.pad(terms.double(), (0, tx * tw - w,
                                                 0, ty * th - h))
    t = t.view(n, b, ty, th, tx, tw).permute(0, 1, 2, 4, 3, 5).reshape(
        n, b * ty * tx, th * tw)
    t = torch.nn.functional.pad(t, (0, 1))         # index -1: a zero
    cells, anchors = _thread_maps()
    gi = t[:7, :, cells.to(t.device)]              # [7, T, passes, NT]
    ge = t[7:, :, anchors.to(t.device)].view(6, 3, *t.shape[1:2],
                                             *anchors.shape)
    # a thread's sum of type tt: its passes in order, families 2tt, 2tt+1
    ge = ge.view(3, 2, 3, *ge.shape[2:]).permute(0, 2, 3, 4, 1, 5)
    ge = ge.reshape(3, 3, ge.shape[2], -1, THREADS)  # [tt, k/c/rest, T, ...]
    edge = _block_sum(_ordered_sum(ge.movedim(3, 0)))          # [tt, m, T]
    cell = _block_sum(_ordered_sum(gi.movedim(2, 0)))          # [7, T]
    return torch.cat([edge.transpose(0, 1).reshape(9, -1), cell]).T


def _reduce_partials(partial: torch.Tensor) -> torch.Tensor:
    """``cloth_grad.cu``'s ``reduce_partials`` on float64 ``[rows, 16]``:
    each of 256 threads sums rows t, t + 256, ... in order, then a tree
    over the threads; rounded once to float32."""
    k = 256
    rows = partial.shape[0]
    p = torch.nn.functional.pad(partial, (0, 0, 0, -rows % k))
    buf = _ordered_sum(p.view(-1, k, partial.shape[1]))
    while k > 1:
        k //= 2
        buf = buf[:k] + buf[k:2 * k]
    return buf[0].float()


def _walk_window_plain(traj, ct_pos, ct_vel, prm, pins, row0,
                       h_global: int):
    """The window adjoint's plain version: :func:`_walk_plain` over the
    trajectory of a row window (``[n, 6, h, W]``, ``row0`` an int) or of
    a batch of windows (``[n, B, 6, h, W]``, B first rows, cotangents
    ``[B, 3, h, W]``, pins ``([B, h, W], [B, 3, h, W])``) with K1w's
    spring masks. The state and pin cotangents are the kernel's; the
    parameter cotangent is summed as the kernel sums it
    (:func:`_kernel_order_partials`, :func:`_reduce_partials`), one
    ``[16]`` for the batch."""
    single = traj.ndim == 4
    if single:
        traj, ct_pos, ct_vel = traj[:, None], ct_pos[None], ct_vel[None]
        row0 = [cloth_kernel._row0_list(row0, None)]
        pins = None if pins is None else (pins[0][None], pins[1][None])
    n, nb, _, h, w = traj.shape
    masks = cloth_kernel._window_masks(h, w, cloth_kernel._row0_list(
        row0, nb), h_global, traj.device)
    # channels first, the windows a batch axis of every plane
    cp, cv = ct_pos.transpose(0, 1), ct_vel.transpose(0, 1)
    pins_t = None if pins is None else (pins[0], pins[1].transpose(0, 1))
    ct_pin = None if pins is None else torch.zeros_like(cp)
    partial = []
    for s in range(n - 1, -1, -1):
        cp, cv, terms, gp = _substep_vjp_planes(
            traj[s].transpose(0, 1), cp, cv, prm, pins_t, masks, terms=True)
        partial.append(_kernel_order_partials(terms))
        if gp is not None:
            ct_pin = ct_pin + gp
    g = (_reduce_partials(torch.cat(partial[::-1])) if partial
         else torch.zeros(16, device=traj.device))
    cp, cv = cp.transpose(0, 1), cv.transpose(0, 1)
    if ct_pin is not None:
        ct_pin = ct_pin.transpose(0, 1)
    if single:
        cp, cv = cp[0], cv[0]
        ct_pin = None if ct_pin is None else ct_pin[0]
    return cp, cv, g, ct_pin


def substep_vjp_tiled(state_in: torch.Tensor, ct_pos: torch.Tensor,
                      ct_vel: torch.Tensor, prm: torch.Tensor, pins=None,
                      tile=None):
    """:func:`substep_vjp_plain` by the kernel's decomposition, on any
    device: every ``tile`` (default :data:`TILE`) core is cut out with the
    state over the core grown by 4 and the incoming cotangent over the
    core grown by 2 (zero beyond both, and beyond the grid), all tiles at
    once as a batch; :func:`_substep_vjp_planes` runs on them with masks
    from grid rows and columns (``cloth_tiled_kernel._tile_masks``) and
    sums only the core cells' parameter terms, and the cores are put back
    together. Its state and pin cotangents equal :func:`substep_vjp_plain`
    bit for bit, which is the halo argument of ``csrc/cloth_grad.cu``."""
    from .cloth_tiled_kernel import _tile_masks, _tiles

    th, tw = tile or TILE
    h, w = state_in.shape[-2:]
    dev = state_in.device
    halo = 4                                  # _tiles' 2k for k = 2
    masks = _tile_masks(h, w, 2, th, tw, dev)
    st = _tiles(state_in, 2, th, tw)
    ty, tx = st.shape[1:3]
    lr = torch.arange(th + 2 * halo, device=dev)
    lc = torch.arange(tw + 2 * halo, device=dev)

    def band(lo, hi_h, hi_w):
        return (((lr >= lo) & (lr < hi_h))[:, None]
                & ((lc >= lo) & (lc < hi_w))[None, :])

    ring2 = band(2, th + 6, tw + 6)
    gr = (torch.arange(ty, device=dev) * th - halo)[:, None, None, None] \
        + lr[:, None]
    gc = (torch.arange(tx, device=dev) * tw - halo)[None, :, None, None] \
        + lc[None, :]
    core = band(halo, th + halo, tw + halo) & (gr < h) & (gc < w)
    ct = torch.where(ring2, _tiles(torch.cat([ct_pos, ct_vel]), 2, th, tw),
                     0.0)
    pins_t = None
    if pins is not None:
        pins_t = (_tiles(pins[0].to(st.dtype), 2, th, tw),
                  _tiles(pins[1], 2, th, tw))
    cp, cv, g, ct_pin = _substep_vjp_planes(st, ct[:3], ct[3:], prm, pins_t,
                                            masks, core)

    def cores(a):
        a = a[..., halo:halo + th, halo:halo + tw]
        return a.permute(0, 1, 3, 2, 4).reshape(
            a.shape[0], ty * th, tx * tw)[:, :h, :w]

    return (cores(cp), cores(cv), g.float(),
            None if ct_pin is None else cores(ct_pin))


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

def _walk_kernel(traj, ct_pos, ct_vel, prm, pins, window=None):
    """The walk of :func:`_walk_plain` with ``csrc/cloth_grad.cu``: one C
    call enqueues, per substep in reverse, one launch of the substep
    adjoint on tiles of :data:`TILE`, ping-ponging the state cotangent
    between two buffers, then one fixed-order reduction of the per-tile
    parameter partials; nothing waits on the host. With ``window = (row0,
    h_global)`` the launches are the window instantiation's
    (``wpe_cloth_substep_vjp_window``), on one window's trajectory
    ``[n, 6, h, W]`` or, one launch a substep for all of them, on a batch
    of windows' ``[n, B, 6, h, W]`` (B first rows in ``row0``; cotangents
    ``[B, 3, h, W]``, pins ``([B, h, W], [B, 3, h, W])``), whose parameter
    cotangent is one ``[16]`` sum."""
    global LAUNCHES, LAUNCHES_WINDOW
    if traj.device.type != "cuda":
        raise ValueError(f"cloth adjoint kernel needs CUDA tensors, got "
                         f"{traj.device}")
    with span("grad.adjoint.issue"):
        single = traj.ndim == 4
        if single:
            traj, ct_pos, ct_vel = traj[:, None], ct_pos[None], ct_vel[None]
            pins = None if pins is None else (pins[0][None], pins[1][None])
        elif window is None:
            raise ValueError(f"traj: expected [n, 6, H, W] for the whole "
                             f"grid, got {tuple(traj.shape)}")
        n, nb, _, h, w = traj.shape
        dev = traj.device
        cloth_kernel._check_plane(traj, (n, nb, 6, h, w), dev, "traj")
        traj = traj.contiguous()
        ct_in = torch.cat([ct_pos, ct_vel], dim=-3).to(dtype=torch.float32)
        cloth_kernel._check_plane(ct_in, (nb, 6, h, w), dev, "ct_pos/ct_vel")
        ct = torch.empty((2, nb, 6, h, w), dtype=torch.float32, device=dev)
        ct[0] = ct_in
        prm = prm.detach().to(device=dev, dtype=torch.float32).contiguous()
        if prm.shape != (16,):
            raise ValueError(f"prm: expected [16], got {tuple(prm.shape)}")
        ct_prm = torch.zeros(16, dtype=torch.float32, device=dev)
        ct_pin = None
        pin_ptrs = (None, None)
        if pins is not None:
            pin_mask = pins[0].to(device=dev, dtype=torch.float32).contiguous()
            cloth_kernel._check_plane(pin_mask, (nb, h, w), dev, "pin_mask")
            ct_pin = torch.zeros((nb, 3, h, w), dtype=torch.float32,
                                 device=dev)
            pin_ptrs = (pin_mask.data_ptr(), ct_pin.data_ptr())
        if n and h * w:
            tiles = -(-h // TILE[0]) * -(-w // TILE[1])
            partial = torch.empty((n, nb * tiles, 16), dtype=torch.float64,
                                  device=dev)
            lib = _build.load("cloth_grad", _SIGNATURES)
            args = (prm.data_ptr(), traj.data_ptr(), pin_ptrs[0],
                    ct[0].data_ptr(), ct[1].data_ptr(), pin_ptrs[1],
                    partial.data_ptr(), ct_prm.data_ptr())
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream().cuda_stream
                if window is None:
                    err = lib.wpe_cloth_substep_vjp(
                        *args, h, w, n, tiles, int(pins is not None), stream)
                else:
                    row0, h_global = window
                    if h_global < 1:
                        raise ValueError(f"h_global must be positive, got "
                                         f"{h_global}")
                    rows = cloth_kernel._row0_device(row0, nb, dev)
                    err = lib.wpe_cloth_substep_vjp_window(
                        *args, nb, h, w, n, tiles, rows.data_ptr(),
                        int(h_global), int(pins is not None), stream)
            _build.check(lib, err, "cloth_grad launch")
            if window is None:
                LAUNCHES += n
            else:
                LAUNCHES_WINDOW += n
    out = ct[n % 2]
    cp, cv = out[:, :3], out[:, 3:]
    if single:
        cp, cv = cp[0], cv[0]
        ct_pin = None if ct_pin is None else ct_pin[0]
    return cp, cv, ct_prm, ct_pin


def substep_vjp_kernel(state_in: torch.Tensor, ct_pos: torch.Tensor,
                       ct_vel: torch.Tensor, prm: torch.Tensor, pins=None):
    """:func:`substep_vjp_plain` with ``csrc/cloth_grad.cu`` on CUDA
    tensors (one substep walked)."""
    return _walk_kernel(state_in[None], ct_pos, ct_vel, prm, pins)


def _dispatch(t: torch.Tensor, plain, kernel):
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return kernel
    raise ValueError(f"no cloth adjoint for device {t.device}")


def substep_vjp(state_in, ct_pos, ct_vel, prm, pins=None):
    """The adjoint of one substep: CPU → the plain version, CUDA → the
    kernel, any other device raises."""
    fn = _dispatch(state_in, substep_vjp_plain, substep_vjp_kernel)
    return fn(state_in, ct_pos, ct_vel, prm, pins)


def walk(traj, ct_pos, ct_vel, prm, pins=None):
    """:func:`substep_vjp` over a trajectory ``[K, 6, H, W]`` in reverse:
    returns the cotangents of pos and vel entering substep 0, the summed
    ``[16]`` parameter cotangent and the summed ``pin_pos`` cotangent."""
    fn = _dispatch(traj, _walk_plain, _walk_kernel)
    return fn(traj, ct_pos, ct_vel, prm, pins)


def walk_window(traj, ct_pos, ct_vel, prm, row0, h_global: int,
                pins=None):
    """:func:`walk` over the trajectory of a row window, or of a batch of
    windows of one shape (``cloth_kernel.trace_window``), with K1w's
    spring masks: CPU → the plain version, CUDA → the kernel's window
    instantiation (one launch a substep for the batch), any other device
    raises. A batch's parameter cotangent is one ``[16]`` sum, in the
    kernel's order in both."""
    fn = _dispatch(traj, _walk_plain, _walk_kernel)
    return fn(traj, ct_pos, ct_vel, prm, pins, (row0, h_global))


# ---------------------------------------------------------------------------
# Segment-checkpointed autograd
# ---------------------------------------------------------------------------

class _Segment(torch.autograd.Function):
    """``n_steps`` substeps whose backward re-runs the segment and walks it
    in reverse. Inputs pos, vel, pin_pos (or None) and the packed vector
    are differentiable; the pin mask is structural."""

    @staticmethod
    def forward(ctx, pos, vel, pin_pos, prm, pin_mask, n_steps):
        state = ClothState(pos=pos, vel=vel, pin_mask=pin_mask,
                           pin_pos=pin_pos)
        with span("grad.segment.forward"):
            out = cloth_kernel.multi_step_packed(state, prm, n_steps)
        ctx.save_for_backward(pos, vel, pin_pos, prm)
        ctx.pin_mask = pin_mask
        ctx.n_steps = n_steps
        return out.pos, out.vel

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_pos, ct_vel):
        pos, vel, pin_pos, prm = ctx.saved_tensors
        pin_mask = ctx.pin_mask
        start = ClothState(pos=pos, vel=vel, pin_mask=pin_mask,
                           pin_pos=pin_pos)
        with span("grad.segment.backward"):
            traj = cloth_kernel.trace(start, prm, ctx.n_steps)
            pins = None if pin_mask is None else (pin_mask, pin_pos)
            cp, cv, g, ct_pin = walk(traj, ct_pos, ct_vel, prm, pins)
            return cp, cv, ct_pin, g.to(prm.dtype), None, None


def multi_step(state: ClothState, params: ClothParams, dt, n_steps: int,
               segment: Optional[int] = None) -> ClothState:
    """Differentiable ``n_steps`` exact substeps of one world
    (``[3, H, W]``): the counterpart of ``cloth_pallas_grad.multi_step``.

    The output equals ``cloth_kernel.multi_step`` bit for bit. Under
    ``torch.autograd`` gradients flow to ``state.pos``, ``state.vel``,
    ``state.pin_pos``, every ``ClothParams`` leaf and ``dt``:
    ``_pack_params`` stays outside the segments, so autograd carries the
    ``speed_damp ** dt`` and ``globe_radius + particle_radius`` chains.
    Segments of ``segment`` substeps (default :data:`DEFAULT_SEGMENT`, the
    last one shorter if ``segment`` does not divide ``n_steps``) each keep
    their start state; the backward holds one segment's trajectory,
    ``segment · 24 · H · W`` bytes. A CPU state takes the plain versions,
    a CUDA state K1 and the adjoint kernel, at any grid size."""
    if n_steps == 0:
        return state
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if state.pos.ndim != 3:
        raise ValueError(f"multi_step_diff takes one world [3, H, W], got "
                         f"{tuple(state.pos.shape)}")
    if state.pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no cloth adjoint for device {state.pos.device}")
    segment = DEFAULT_SEGMENT if segment is None else segment
    if segment < 1:
        raise ValueError(f"segment must be >= 1, got {segment}")
    segment = min(segment, n_steps)
    with span("grad.forward"):
        prm = cloth_kernel._pack_params(params, dt).to(state.pos.device)
        n_seg, rem = divmod(n_steps, segment)
        pos, vel = state.pos, state.vel
        for k in [segment] * n_seg + ([rem] if rem else []):
            pos, vel = _Segment.apply(pos, vel, state.pin_pos, prm,
                                      state.pin_mask, k)
    return state._replace(pos=pos, vel=vel)


class _WindowSegment(torch.autograd.Function):
    """``n_steps`` substeps of a row window or a batch of windows
    (``cloth_kernel.multi_step_window_packed``: K1w, or K6w a window at a
    time, their plain version on the CPU) whose backward re-runs them with
    ``cloth_kernel.trace_window`` and walks them in reverse with
    :func:`walk_window`, each one call for the batch. It saves only the
    windows' input. Inputs pos, vel, pin_pos (or None) and the packed
    vector are differentiable; the pin mask and the first rows are
    structural."""

    @staticmethod
    def forward(ctx, pos, vel, pin_pos, prm, pin_mask, n_steps, row0,
                h_global):
        out = cloth_kernel.multi_step_window_packed(
            pos, vel, pin_mask, pin_pos, prm, n_steps, row0, h_global)
        ctx.save_for_backward(pos, vel, pin_pos, prm)
        ctx.pin_mask = pin_mask
        ctx.args = (n_steps, row0, h_global)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, ct_pos, ct_vel):
        pos, vel, pin_pos, prm = ctx.saved_tensors
        n_steps, row0, h_global = ctx.args
        pin_mask = ctx.pin_mask
        traj = cloth_kernel.trace_window(pos, vel, pin_mask, pin_pos, prm,
                                         n_steps, row0, h_global)
        pins = None if pin_mask is None else (pin_mask, pin_pos)
        cp, cv, g, ct_pin = walk_window(traj, ct_pos, ct_vel, prm, row0,
                                        h_global, pins)
        return cp, cv, ct_pin, g.to(prm.dtype), None, None, None, None


def multi_step_window(pos, vel, pin_mask, pin_pos, prm: torch.Tensor,
                      n_steps: int, row0, h_global: int):
    """Differentiable ``n_steps`` substeps of a halo-extended row window,
    or of a batch of windows of one shape: ``cloth_kernel.
    multi_step_window_packed``'s arguments and output, bit for bit, with
    gradients to ``pos``, ``vel``, ``pin_pos`` and the packed ``prm`` (the
    caller packs it with ``cloth_kernel._pack_params`` outside, so
    autograd carries the parameters' chains). The backward holds one
    call's trajectory, ``n_steps · 24 · h · W`` bytes a window: the rows
    path calls it once a device and exchange block with every window the
    device holds, so its checkpoints are the blocks. A CPU window takes
    the plain versions, a CUDA window K1w (or K6w) forward and the window
    adjoint kernel."""
    if n_steps < 0:
        raise ValueError(f"n_steps must be >= 0, got {n_steps}")
    if pos.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no cloth adjoint for device {pos.device}")
    if n_steps == 0:
        return pos, vel
    return _WindowSegment.apply(pos, vel, pin_pos, prm, pin_mask, n_steps,
                                row0, h_global)
