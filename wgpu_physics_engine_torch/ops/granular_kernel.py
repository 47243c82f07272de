"""Granular contact on sorted state: the rebuild-time slab structures, the
CUDA kernels K10 (a substep), K11 (the pair forces alone) and K12 (the
forces and their directional derivative), their plain torch versions, and
the dispatch between them.

The counterpart of ``wgpu_physics_engine_tpu/ops/granular_pallas.py``
(``substep_sorted`` → ``_kernel``, kernel K10, with its three pair phases
``_pair_force_phase``, ``_pair_force_phase_pipelined`` and
``_pair_force_phase_civ``; ``contact_forces_sorted`` → ``_forces_kernel``,
K11; ``contact_force_jvp_sorted`` → ``_jvp_kernel``, K12):

* the rebuild-time code is plain torch, equal to the JAX package's bit for
  bit: :func:`civ_bounds`, :func:`build_windows` (per-particle window
  ranges, the window formulation) and :func:`build_offsets_civ` (the CIV
  formulation: per-block slab offsets only, the exact ``stats=True``
  dropped count or the sound fast indicator). Both return a
  :class:`SlabSet`, the frozen candidate set of one rebuild block;
* :func:`substep_sorted_plain` computes one substep over that set in eager
  torch (of all sorted slots, or with ``base`` and ``n_local`` of the
  slots ``[base, base + n_local)`` only, the shard body of
  ``parallel/granular_mesh.py``, kernel K10b): per group, the candidates
  of each particle's window that lie in its block's slab A ``[offa, offa + slab)`` or, when ``offb > offa``, in
  slab B from ``max(offb, offa + slab)`` to ``offb + slab`` — the two
  interval tests of the TPU kernel, so the candidate set (and ``dropped``)
  is the JAX package's even when slabs truncate windows. It gathers each
  group's candidates at the widest window of a chunk of particles and sums
  the A parts group by group, then the B parts, then adds the two, K10's
  order (a group's sum in double, rounded once, as in the kernel);
* :func:`contact_forces_sorted_plain` is that force alone, and
  :func:`contact_force_jvp_sorted_plain` the force with ``J·u`` written by
  hand (K12's terms; the tests hold it against ``torch.autograd``);
* :func:`substep_sorted_kernel`, :func:`contact_forces_sorted_kernel` and
  :func:`contact_force_jvp_sorted_kernel` launch the three entry points of
  ``csrc/granular_step.cu`` once per call on the current stream (one slab
  walk, with :func:`lanes` lanes a sorted particle: one on the full
  candidate set, several on a thin one, whose windows are long; the thin
  set staged in shared memory, the full set read directly, see
  :func:`walk_geometry`);
* :func:`substep_sorted`, :func:`contact_forces_sorted` and
  :func:`contact_force_jvp_sorted` take the plain version for a CPU tensor
  and the kernel for a CUDA tensor, and raise for anything else. There is
  no fallback and no size limit.

Full CIV (9 cid intervals), thin CIV (3) and the window formulation
(``civ=False``, or grids with a dimension below 3) are one kernel: only
the windows differ (from ``cell_start`` and the cid, or read from the
``windows`` table). The TPU's ``pipeline`` option changes no bit of K10's
result and has no counterpart; nor have the padding to ``n_pad`` (it
survives only in the clipping of the slab offsets, which binds the
candidate set), ``_NGP`` group padding, the 8-row SMEM offset tiles, the
f32 cid plane or ``_CHUNK_BUDGET``.

Pair force: ``touching = valid & d2 < md² & d2 > 1e-12`` and ``w =
k·(md/sqrt(d2) − 1)``, summed as ``w·d``, then gravity on y, semi-implicit
Euler and the wall clamp and reflect per axis, the op order of
``models/granular._frozen_substep``. Both versions take ``1/sqrt`` (the
TPU kernel's rsqrt is one rounding away) and write out of place.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..models import broadphase
from . import _build

_I32 = torch.int32

# Kernel launches by :func:`substep_sorted_kernel` (one per substep): K10
# over all sorted slots, and K10b (``n_local`` given, a slice of the slots)
# apart. A run reads them to show that its path went through the kernel.
LAUNCHES = 0
LAUNCHES_SHARDED = 0

# Kernel launches by :func:`contact_forces_sorted_kernel` (K11) and
# :func:`contact_force_jvp_sorted_kernel` (K12), one per call.
LAUNCHES_FORCES = 0
LAUNCHES_JVP = 0

_SIGNATURES = {
    "wpe_granular_step": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                         + [ctypes.c_void_p],
    "wpe_granular_forces": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                           + [ctypes.c_void_p],
    "wpe_granular_force_jvp": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                              + [ctypes.c_void_p],
}

# The kernels' walk: the most lanes a sorted slot takes (see :func:`lanes`)
# and the threads of a CTA when it takes several.
MAX_LANES = 8
CTA_THREADS = 512

# elements (rows × window) a gather of the plain version may hold, and the
# rows over which it takes the widest window
_PLAIN_ELEMS = 1 << 24
_TILE_ROWS = 1024


class SlabSet(NamedTuple):
    """The frozen candidate set of one rebuild block: the slab offsets of
    each block of ``block`` sorted slots and either the window table
    (window formulation) or the sorted cids with ``cell_start`` and the
    cid intervals (CIV)."""

    off: torch.Tensor                       # [nb, ng, 2] int32 (offa, offb)
    block: int
    slab: int
    windows: Optional[torch.Tensor] = None  # [2, n, ng] int32 starts, ends
    cid: Optional[torch.Tensor] = None      # [n] int32 sorted cell ids
    cell_start: Optional[torch.Tensor] = None   # [num_cells + 3] int32
    bounds: Optional[Tuple[Tuple[int, int], ...]] = None  # CIV intervals

    @property
    def ng(self) -> int:
        return self.off.shape[1]


def _floordiv(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def _slab_offsets(hs: torch.Tensor, he: torch.Tensor, slab: int, n_pad: int):
    """128-aligned A/B slab offsets of each block from the head ``hs`` and
    end ``he`` of its window hull ([nb, ng]), clipped to ``[0, n_pad -
    slab]``; ``offb == offa`` means "no slab B"."""
    hi = n_pad - slab
    offa = torch.clamp(_floordiv(hs, 128) * 128, 0, hi)
    offb_raw = torch.clamp(_floordiv(he - slab + 127, 128) * 128, 0, hi)
    need_b = he > offa + slab
    return offa, torch.where(need_b, offb_raw, offa), need_b


def _exact_dropped(s, e, offa, offb, n, block, slab, n_pad):
    """Window entries outside both slabs (per-particle windows ``s``/``e``
    [n, ng]), saturated at 2**31 - 128."""
    pad = n_pad - n
    nb = n_pad // block
    ng = s.shape[1]
    sblk = torch.nn.functional.pad(s.long(), (0, 0, 0, pad),
                                   value=n).reshape(nb, block, ng)
    eblk = torch.nn.functional.pad(e.long(), (0, 0, 0, pad),
                                   value=n).reshape(nb, block, ng)
    oa = offa[:, None, :].long()
    ob = offb[:, None, :].long()
    gap = torch.clamp_min(torch.minimum(eblk, ob)
                          - torch.maximum(sblk, oa + slab), 0)
    beyond = torch.clamp_min(eblk - torch.maximum(sblk, ob + slab), 0)
    return torch.clamp_max((gap + beyond).sum(), 2 ** 31 - 128).to(_I32)


def civ_bounds(spec: broadphase.GridSpec, thin: bool):
    """Static per-group cid-difference intervals of CIV mode: candidate j
    is valid for centre i in group g iff ``cid_j - cid_i ∈ [lo_g, hi_g]``.
    Full mode, group (dx, dy): ``dx·D + dy·d2 ± 1`` (the exact z-triple);
    thin mode, group dx: ``dx·D ± (d2 + 1)`` (the y/z-merged superset). The
    intervals do not clip at grid borders; a wrapped cell lies ≥ 2 cells
    away along some axis (hence ``dims ≥ 3``), outside the contact
    distance."""
    if spec.num_cells >= 2 ** 24:
        raise ValueError("cid exceeds the f32 exact-integer range of the "
                         "reference's cid plane")
    if min(spec.dims) < 3:
        raise ValueError(f"CIV border-wrap safety needs dims >= 3 (got "
                         f"{spec.dims})")
    d1, d2 = spec.dims[1], spec.dims[2]
    big = d1 * d2
    if thin:
        return tuple((dx * big - d2 - 1, dx * big + d2 + 1)
                     for dx in (-1, 0, 1))
    return tuple((dx * big + dy * d2 - 1, dx * big + dy * d2 + 1)
                 for dx, dy in broadphase.OFFSETS_XY)


def build_windows(grid: broadphase.SortedGrid, spec: broadphase.GridSpec,
                  block: int, slab: int, n_pad: int, thin: bool = False
                  ) -> Tuple[SlabSet, torch.Tensor]:
    """Per-particle window ranges and per-block slab offsets (the window
    formulation, ``granular_pallas.build_windows``). Default: the 9
    z-triple windows of ``broadphase.group_window_ranges``; ``thin=True``:
    three dx groups, each one merged range from ``cell_start[lin(x+dx,
    y-1, z-1)]`` to ``cell_start[lin(x+dx, y+1, z+1) + 1]``. Windows of an
    off-grid group are empty and anchored at the particle's own slot, so
    border blocks keep tight hulls.

    Returns ``(SlabSet, dropped)``: the windows as ``[2, n, ng]`` int32
    and ``dropped``, the window entries outside both slabs (int32 0-d)."""
    n = grid.sorted_cid.shape[0]
    dev = grid.sorted_cid.device
    d0, d1, d2 = spec.dims
    cid = grid.sorted_cid.to(_I32)
    cx = _floordiv(cid, d1 * d2)
    rem = cid - cx * (d1 * d2)
    c = torch.stack([cx, _floordiv(rem, d2), rem - _floordiv(rem, d2) * d2])
    cs = grid.cell_start
    if thin:
        y0 = torch.clamp_min(c[1] - 1, 0)
        y1 = torch.clamp_max(c[1] + 1, d1 - 1)
        z0 = torch.clamp_min(c[2] - 1, 0)
        z1 = torch.clamp_max(c[2] + 1, d2 - 1)
        starts_l, ends_l, oks_l = [], [], []
        for dx in (-1, 0, 1):
            okx = (c[0] + dx >= 0) & (c[0] + dx < d0)
            ncx = torch.clamp(c[0] + dx, 0, d0 - 1)
            lo = (ncx * d1 + y0) * d2 + z0
            hi = (ncx * d1 + y1) * d2 + z1
            starts_l.append(cs[lo.long()])
            ends_l.append(cs[(hi + 1).long()])
            oks_l.append(okx)
        g_starts = torch.stack(starts_l, dim=-1)
        g_ends = torch.stack(ends_l, dim=-1)
        g_ok = torch.stack(oks_l, dim=-1)
    else:
        g_starts, g_ends, g_ok = broadphase.group_window_ranges(c, spec, cs)
    slot = torch.arange(n, dtype=_I32, device=dev)[:, None]
    starts = torch.where(g_ok, g_starts, slot)               # [n, ng]
    ends = torch.where(g_ok, g_ends, slot)
    pad = n_pad - n
    nb = n_pad // block
    ng = starts.shape[1]
    # pad rows hold the empty window [n, n): the last block's hull stays at
    # the array tail
    sblk = torch.nn.functional.pad(starts, (0, 0, 0, pad),
                                   value=n).reshape(nb, block, ng)
    eblk = torch.nn.functional.pad(ends, (0, 0, 0, pad),
                                   value=n).reshape(nb, block, ng)
    smin = sblk.amin(1)
    emax = eblk.amax(1)
    offa, offb, _ = _slab_offsets(smin, emax, slab, n_pad)
    dropped = _exact_dropped(starts, ends, offa, offb, n, block, slab, n_pad)
    off = torch.stack([offa, offb], dim=-1).to(_I32).contiguous()
    windows = torch.stack([starts, ends]).to(_I32).contiguous()
    return SlabSet(off=off, block=block, slab=slab, windows=windows), dropped


def build_offsets_civ(grid: broadphase.SortedGrid, spec: broadphase.GridSpec,
                      block: int, slab: int, n_pad: int, thin: bool = False,
                      stats: bool = False) -> Tuple[SlabSet, torch.Tensor]:
    """Per-block slab offsets of CIV mode (``granular_pallas.
    build_offsets_civ``): by monotonicity of ``cell_start`` a block's
    window hull is ``cell_start[cmin + lo_g]`` .. ``cell_start[cmax + hi_g +
    1]``, two gathers per block and group instead of per particle.

    ``dropped``: with ``stats=True`` the exact count of window entries
    outside both slabs (per-particle gathers); with ``stats=False`` the
    reference's SOUND fast indicator, nonzero whenever entries are really
    dropped, which may over-report (an empty window whose anchor lies in
    the A–B gap fires it with nothing dropped). Ported as it is.

    Returns ``(SlabSet, dropped)`` with the sorted cids, ``cell_start`` and
    the intervals of :func:`civ_bounds`."""
    n = grid.sorted_cid.shape[0]
    bounds = civ_bounds(spec, thin)
    nb = n_pad // block
    pad = n_pad - n
    ncells = spec.num_cells
    cid = grid.sorted_cid.to(_I32)
    cs = grid.cell_start
    cid_pad = (torch.cat([cid, cid[-1:].expand(pad)]) if pad else cid).long()
    cblk = cid_pad.reshape(nb, block)
    cmin = cblk.amin(1)
    cmax = cblk.amax(1)
    hs = torch.stack([cs[torch.clamp(cmin + lo, 0, ncells)]
                      for lo, _ in bounds], dim=-1).long()    # [nb, ng]
    he = torch.stack([cs[torch.clamp(cmax + hi + 1, 0, ncells)]
                      for _, hi in bounds], dim=-1).long()
    he = torch.maximum(he, hs)
    offa, offb, need_b = _slab_offsets(hs, he, slab, n_pad)
    slabs = SlabSet(off=torch.stack([offa, offb], dim=-1).to(_I32).contiguous(),
                    block=block, slab=slab, cid=cid.contiguous(),
                    cell_start=cs.contiguous(), bounds=bounds)
    if stats:
        s, e = group_windows(slabs)
        return slabs, _exact_dropped(s, e, offa, offb, n, block, slab, n_pad)
    beyond = torch.clamp_min(he - (offb + slab), 0).sum()
    gaps = []
    for g, (lo, hi) in enumerate(bounds):
        ob = offb[:, g]
        # s_i < offb  <=>  cid_i <= cid[offb - 1] - lo (cell_start /
        # sorted-cid duality); the largest such cid has the largest window
        # end among the windows reaching the gap
        qb = cid_pad[torch.clamp(ob - 1, 0, n_pad - 1)]
        t = qb - lo
        cstar = torch.where(cblk <= t[:, None], cblk, -1).amax(1)
        e_star = cs[torch.clamp(cstar + hi + 1, 0, ncells)].long()
        cnt = torch.clamp_min(torch.minimum(e_star, ob) - (offa[:, g] + slab),
                              0)
        gaps.append(torch.where(need_b[:, g] & (cstar >= 0), cnt, 0))
    dropped = beyond + torch.stack(gaps).sum()
    return slabs, torch.clamp_max(dropped, 2 ** 31 - 128).to(_I32)


def group_windows(slabs: SlabSet, rows: slice = slice(None)
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-particle window ``(starts, ends)`` ``[n, ng]`` int64 of the
    sorted slots ``rows`` (all by default): read from the window table, or
    in CIV mode ``cell_start[clip(cid + lo_g)]`` ..
    ``cell_start[clip(cid + hi_g + 1)]``, the slots whose cid difference
    lies in the group's interval."""
    if slabs.windows is not None:
        return slabs.windows[0, rows].long(), slabs.windows[1, rows].long()
    ncells = slabs.cell_start.shape[0] - 3
    cid = slabs.cid[rows].long()
    cs = slabs.cell_start
    s = torch.stack([cs[torch.clamp(cid + lo, 0, ncells)]
                     for lo, _ in slabs.bounds], dim=-1)
    e = torch.stack([cs[torch.clamp(cid + hi + 1, 0, ncells)]
                     for _, hi in slabs.bounds], dim=-1)
    return s.long(), e.long()


def slab_ranges(slabs: SlabSet, n: int, base: int = 0):
    """The candidate ranges ``(a_lo, a_hi), (b_lo, b_hi)`` ``[n, ng]`` of
    the ``n`` sorted slots from ``base``: each one's window inside its
    block's slab A, and inside slab B past slab A (empty where ``hi <=
    lo``)."""
    s, e = group_windows(slabs, slice(base, base + n))
    blk = _floordiv(torch.arange(base, base + n, device=s.device),
                    slabs.block)
    oa = slabs.off[blk, :, 0].long()
    ob = slabs.off[blk, :, 1].long()
    a_lo = torch.maximum(s, oa)
    a_hi = torch.minimum(e, oa + slabs.slab)
    b_lo = torch.maximum(s, torch.maximum(ob, oa + slabs.slab))
    b_hi = torch.where(ob > oa, torch.minimum(e, ob + slabs.slab), b_lo)
    return (a_lo, a_hi), (b_lo, b_hi)


def candidate_count(slabs: SlabSet, n: int) -> int:
    """Candidate slots the substep tests over all particles (window ∩
    slab coverage): the data-dependent work of one substep."""
    (a_lo, a_hi), (b_lo, b_hi) = slab_ranges(slabs, n)
    return int(torch.clamp_min(a_hi - a_lo, 0).sum()
               + torch.clamp_min(b_hi - b_lo, 0).sum())


def kernel_params(config, dt, device, k_contact=None, gravity=None,
                  restitution=None) -> torch.Tensor:
    """The 6-float parameter vector on ``device``: 0:min_dist 1:k_contact
    2:gravity 3:dt 4:restitution 5:wall_limit. ``k_contact`` / ``gravity``
    / ``restitution`` / ``dt`` may be 0-d tensors (a slider rewrites them
    and rebuilds nothing); ``None`` takes the config's value."""
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32).to(device)

    return torch.stack([
        2.0 * f32(config.radius),
        f32(config.k_contact if k_contact is None else k_contact),
        f32(config.gravity if gravity is None else gravity),
        f32(dt),
        f32(config.restitution if restitution is None else restitution),
        f32(config.bounds - config.radius),
    ])


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _chunks(tile_max, n: int):
    """Consecutive row ranges ``(r0, r1, width)`` over ``_TILE_ROWS``-row
    tiles with per-tile widest windows ``tile_max``: each range holds at
    most ``_PLAIN_ELEMS`` gathered elements at its widest window (or one
    tile). Tiles without candidates are skipped."""
    out, r0, w = [], None, 0
    for t, wt in enumerate(tile_max):
        a = t * _TILE_ROWS
        if wt == 0:
            if r0 is not None:
                out.append((r0, a, w))
                r0 = None
            continue
        if r0 is not None and (a + _TILE_ROWS - r0) * max(w, wt) > _PLAIN_ELEMS:
            out.append((r0, a, w))
            r0 = None
        if r0 is None:
            r0, w = a, 0
        w = max(w, wt)
    if r0 is not None:
        out.append((r0, n, w))
    return out


def _pass_pairs(pos: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, md,
                base: int = 0):
    """The candidates ``[lo, hi)`` of each particle and group, gathered
    group by group in row chunks: yields ``(r0, r1, idx, (dx, dy, dz), d2,
    touching)``, each ``[r1 - r0, width]`` at the chunk's widest window
    (``idx`` the candidates' slots). Row r of ``lo``/``hi`` is sorted slot
    ``base + r`` of ``pos``."""
    n, ng = lo.shape
    if n == 0:
        return
    width = torch.clamp_min(hi - lo, 0)
    n_tiles = -(-n // _TILE_ROWS)
    tile_max = torch.nn.functional.pad(
        width, (0, 0, 0, n_tiles * _TILE_ROWS - n)).reshape(
            n_tiles, _TILE_ROWS, ng).amax(1).T.tolist()       # one sync
    md2 = md * md
    rows_all = torch.arange(base, base + n, device=pos.device)
    for g in range(ng):
        for r0, r1, w in _chunks(tile_max[g], n):
            rows = rows_all[r0:r1, None]
            idx = lo[r0:r1, g, None] + torch.arange(w, device=pos.device)
            valid = (idx < hi[r0:r1, g, None]) & (idx != rows)
            idx = torch.clamp_max(idx, pos.shape[1] - 1)
            s0, s1 = base + r0, base + r1
            dx = pos[0, s0:s1, None] - pos[0][idx]
            dy = pos[1, s0:s1, None] - pos[1][idx]
            dz = pos[2, s0:s1, None] - pos[2][idx]
            d2 = dx * dx + dy * dy + dz * dz
            touching = valid & (d2 < md2) & (d2 > 1e-12)
            yield r0, r1, idx, (dx, dy, dz), d2, touching


def _pass_sums(pos: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               md, kc, u: Optional[torch.Tensor] = None,
               base: int = 0) -> torch.Tensor:
    """Pair-force sums ``[3, n]`` over the candidates ``[lo, hi)`` of each
    particle and group, group by group (each group's sum added to the
    running total, K10's order). Each term ``w·d`` is a float; a group's
    sum is taken in double and rounded once, as the kernel does, so the
    two agree whatever order the terms are summed in (but for rounding
    ties).

    With a tangent field ``u`` ``[3, n]`` also the sums of the directional
    derivative, ``[6, n]`` (f, then J·u), K12's terms written by hand:
    ``w·du − g·d`` with ``du = u_i − u_j`` and ``g = k·md·inv³·(d·du)``
    (the comparisons are constants). Row r of ``lo``/``hi`` and of the
    result is sorted slot ``base + r``."""
    out = torch.zeros((3 if u is None else 6, lo.shape[0]), dtype=pos.dtype,
                      device=pos.device)
    for r0, r1, idx, ds, d2, touching in _pass_pairs(pos, lo, hi, md, base):
        inv = 1.0 / torch.sqrt(torch.where(touching, d2, 1.0))
        wgt = torch.where(touching, kc * (md * inv - 1.0), 0.0)
        for a, d in enumerate(ds):
            s = torch.sum((wgt * d).double(), dim=1)
            out[a, r0:r1] += s.float()
        if u is None:
            continue
        dus = [u[a, base + r0:base + r1, None] - u[a][idx]
               for a in range(3)]
        dot = ds[0] * dus[0] + ds[1] * dus[1] + ds[2] * dus[2]
        g = torch.where(touching, kc * md * inv * inv * inv * dot, 0.0)
        for a, (d, du) in enumerate(zip(ds, dus)):
            s = torch.sum((wgt * du - g * d).double(), dim=1)
            out[3 + a, r0:r1] += s.float()
    return out


def touching_count(pos: torch.Tensor, params: torch.Tensor,
                   slabs: SlabSet) -> int:
    """Candidate slots of one substep on sorted ``pos`` that touch (the
    pairs whose force the substep computes, each seen from both ends): with
    :func:`candidate_count`, the data-dependent work of one substep."""
    md = params.to(pos.device)[0]
    (a_lo, a_hi), (b_lo, b_hi) = slab_ranges(slabs, pos.shape[1])
    total = torch.zeros((), dtype=torch.int64, device=pos.device)
    for lo, hi in ((a_lo, a_hi), (b_lo, b_hi)):
        for *_, touching in _pass_pairs(pos, lo, hi, md):
            total += touching.sum()
    return int(total)


def _integrate(pos, vel, f, params):
    """Gravity on y → semi-implicit Euler → wall clamp & reflect, per
    axis (``_kernel`` :724-747). Differentiable in every input (the
    gradient path's transpose of the integrate is ``torch.autograd`` of
    this function)."""
    _, _, grav, dt, e, lim = params.unbind(0)
    fx, fy, fz = f.unbind(0)
    fy = fy + grav                                        # unit mass
    new_p, new_v = [], []
    for p0, v0, fa in zip(pos.unbind(0), vel.unbind(0), (fx, fy, fz)):
        v = v0 + fa * dt
        p = p0 + v * dt
        hit = ((p < -lim) & (v < 0.0)) | ((p > lim) & (v > 0.0))
        new_p.append(torch.minimum(torch.maximum(p, -lim), lim))
        new_v.append(torch.where(hit, -e * v, v))
    return torch.stack(new_p), torch.stack(new_v)


def _md_kc(md, kc, device):
    return (torch.as_tensor(md, dtype=torch.float32).detach().to(device),
            torch.as_tensor(kc, dtype=torch.float32).detach().to(device))


def _slab_sums(pos, md, kc, slabs: SlabSet, u=None, base: int = 0,
               n_local: Optional[int] = None) -> torch.Tensor:
    """Slab A's sums, then slab B's, then their sum: K10's force (and
    with ``u`` K12's J·u beside it) on the sorted slots ``[base, base +
    n_local)`` (all by default)."""
    md, kc = _md_kc(md, kc, pos.device)
    n = pos.shape[1] - base if n_local is None else n_local
    (a_lo, a_hi), (b_lo, b_hi) = slab_ranges(slabs, n, base)
    return (_pass_sums(pos, a_lo, a_hi, md, kc, u, base)
            + _pass_sums(pos, b_lo, b_hi, md, kc, u, base))


def contact_forces_sorted_plain(pos: torch.Tensor, md, kc,
                                slabs: SlabSet) -> torch.Tensor:
    """The pair contact forces ``[3, n]`` on sorted ``pos`` ``[3, n]`` over
    the candidate set ``slabs`` (contact distance ``md``, stiffness ``kc``,
    floats or 0-d tensors), on any device."""
    return _slab_sums(pos, md, kc, slabs)


def contact_force_jvp_sorted_plain(pos: torch.Tensor, u: torch.Tensor, md,
                                   kc, slabs: SlabSet) -> torch.Tensor:
    """The pair forces and their directional derivative along ``u``
    ``[3, n]`` (sorted like ``pos``): ``[6, n]``, f then J·u, on any
    device. Its f equals :func:`contact_forces_sorted_plain`'s bit for
    bit; J·u is written by hand, not taken from ``torch.autograd``."""
    return _slab_sums(pos, md, kc, slabs, u)


def _slice_args(pos: torch.Tensor, slabs: SlabSet, base: int,
                n_local: Optional[int]) -> int:
    """Checks the slice ``[base, base + n_local)`` of the sorted slots
    (``n_local`` None: all of them, from base 0) and returns its length."""
    n = pos.shape[-1]
    if n_local is None:
        if base:
            raise ValueError("a base needs its local count n_local")
        return n
    if base < 0 or n_local < 0 or base + n_local > n or base % slabs.block:
        raise ValueError(f"slots [{base}, {base} + {n_local}) must lie in the "
                         f"{n} sorted slots and start on a block of "
                         f"{slabs.block}")
    return n_local


def substep_sorted_plain(pos: torch.Tensor, vel: torch.Tensor,
                         params: torch.Tensor, slabs: SlabSet, base: int = 0,
                         n_local: Optional[int] = None):
    """One substep on sorted state over the candidate set ``slabs``, on any
    device: of all slots (``pos``/``vel`` ``[3, n]``), or of the slots
    ``[base, base + n_local)`` only (K10b: ``pos`` the full ``[3, n]``,
    ``vel`` the slots' own ``[3, n_local]``, ``base`` a multiple of the
    block). Returns the slots' new ``(pos, vel)``."""
    n_local = _slice_args(pos, slabs, base, n_local)
    params = params.to(pos.device)
    f = _slab_sums(pos, params[0], params[1], slabs, base=base,
                   n_local=n_local)
    return _integrate(pos[:, base:base + n_local], vel, f, params)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------

def _check(a: torch.Tensor, dtype, shape, device, what: str) -> None:
    if a.dtype != dtype or tuple(a.shape) != tuple(shape) or a.device != device:
        raise ValueError(f"{what}: expected {dtype} {tuple(shape)} on {device}, "
                         f"got {a.dtype} {tuple(a.shape)} on {a.device}")


def lanes(slabs: SlabSet, n: int, resident: int) -> int:
    """Lanes a sorted slot in the kernels' walk over ``slabs`` (``n``
    slots, a card that holds ``resident`` threads at once), the same for
    K10, K11 and K12: the lanes split a slot's window in stride and merge
    their double sums in a fixed butterfly. The full candidate set (9
    groups: the z-triple windows of a cell's 3×3 neighbours, ~6 candidates
    each in a pile) keeps one lane, a thread a slot: more lanes would idle.
    A thin set (3 groups: each window runs over whole z-rows of cells, ~10³
    candidates on the self-colliding cloth) takes the most lanes, a power
    of two up to :data:`MAX_LANES`, with which its slots still fit the
    card's resident threads: 4 for the 65,536 slots of a 256² cloth on an
    H100 (270,336 threads), 1 for a pile of 1M, whose slots fill the card
    alone."""
    n_lanes = 1
    if slabs.ng <= 3:
        while n_lanes < MAX_LANES and 2 * n_lanes * n <= resident:
            n_lanes *= 2
    return n_lanes


def staged(slabs: SlabSet) -> bool:
    """Whether the kernels' walk stages its slabs in shared memory: on a
    thin set (3 groups of long windows, each staged slot read by many of
    them), not on the full set (9 groups of ~6 candidates each), where
    staging group by group, two barriers a group and slab, cost more than
    the walk; the direct walk reads each candidate from global memory (L2,
    and L1 for the overlapping windows of neighbouring slots)."""
    return slabs.ng <= 3


def walk_geometry(slabs: SlabSet, n: int, resident: int
                  ) -> Tuple[int, int, bool]:
    """``(lanes, cta, stage)``: lanes a slot (:func:`lanes`), slots a CTA
    of the kernels' walk and whether it stages (:func:`staged`). One lane:
    a CTA a rebuild block, as the slab offsets are cut (the direct walk
    measured the same with CTAs of 32 to 128 slots). Several: the largest
    divisor of the block that keeps the CTA within :data:`CTA_THREADS`
    threads (every CTA then lies in one block)."""
    n_lanes = lanes(slabs, n, resident)
    stage = staged(slabs)
    if n_lanes == 1:
        return 1, slabs.block, stage
    cap = max(1, min(slabs.block, CTA_THREADS // n_lanes))
    return n_lanes, _largest_divisor(slabs.block, cap), stage


@functools.lru_cache(maxsize=None)
def _largest_divisor(block: int, cap: int) -> int:
    return max(d for d in range(1, cap + 1) if block % d == 0)


def resident_threads(dev: torch.device) -> int:
    """Threads the card of ``dev`` holds at once (SMs × threads an SM)."""
    return _resident(torch.cuda.current_device() if dev.index is None
                     else dev.index)


@functools.lru_cache(maxsize=None)
def _resident(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count * props.max_threads_per_multi_processor


def _cand_args(slabs: SlabSet, n: int, dev, slots: Optional[int] = None):
    """The candidate set as the C entry points take it: ``(cid, cell_start,
    windows, off)`` pointers (None where unused), the host bounds table, and
    ``(ng, block, slab, ncells, lanes, cta, stage)`` for a launch over
    ``slots`` of the ``n`` sorted slots (all by default); plus the tensors
    the pointers read, which the caller keeps alive over the launch."""
    block, slab, ng = slabs.block, slabs.slab, slabs.ng
    if not 1 <= block <= 1024 or slab < 1 or not 1 <= ng <= 9:
        raise ValueError(f"granular kernel takes 1 <= block <= 1024, slab >= 1 "
                         f"and 1..9 groups (got {block}, {slab}, {ng})")
    if slabs.off.shape[0] * block < n:
        raise ValueError(f"slab offsets cover {slabs.off.shape[0]} blocks of "
                         f"{block}, fewer than {n} particles")
    _check(slabs.off, _I32, (slabs.off.shape[0], ng, 2), dev, "off")
    off = slabs.off.contiguous()
    bounds = (ctypes.c_int * 18)()
    if slabs.windows is not None:
        _check(slabs.windows, _I32, (2, n, ng), dev, "windows")
        keep = (off, slabs.windows.contiguous())
        ptrs = (None, None, keep[1].data_ptr(), off.data_ptr())
        ncells = 0
    else:
        if slabs.bounds is None or len(slabs.bounds) != ng:
            raise ValueError("CIV slabs need one cid interval per group")
        _check(slabs.cid, _I32, (n,), dev, "cid")
        cs = slabs.cell_start.contiguous()
        _check(cs, _I32, (cs.shape[0],), dev, "cell_start")
        keep = (off, slabs.cid.contiguous(), cs)
        ptrs = (keep[1].data_ptr(), cs.data_ptr(), None, off.data_ptr())
        ncells = cs.shape[0] - 3
        for g, (lo, hi) in enumerate(slabs.bounds):
            bounds[g], bounds[ng + g] = lo, hi
    n_lanes, cta, stage = walk_geometry(slabs, n if slots is None else slots,
                                        resident_threads(dev))
    dims = (ng, block, slab, ncells, n_lanes, cta, int(stage))
    return ptrs, bounds, dims, keep


def _cuda_pos(pos: torch.Tensor, what: str) -> torch.Tensor:
    if pos.device.type != "cuda":
        raise ValueError(f"{what} needs CUDA tensors, got {pos.device}")
    _check(pos, torch.float32, (3, pos.shape[-1]), pos.device, "pos")
    return pos.contiguous()


def substep_sorted_kernel(pos: torch.Tensor, vel: torch.Tensor,
                          params: torch.Tensor, slabs: SlabSet, base: int = 0,
                          n_local: Optional[int] = None):
    """One substep of ``csrc/granular_step.cu`` on CUDA tensors: one launch
    on the current stream, the walk of :func:`walk_geometry` (one lane a
    slot and a CTA a block of ``slabs.block`` <= 1024 sorted slots on the
    full candidate set), new output buffers (the inputs are only read).
    With ``n_local`` it steps the slots ``[base, base + n_local)`` (K10b,
    counted in ``LAUNCHES_SHARDED``), as :func:`substep_sorted_plain`."""
    global LAUNCHES, LAUNCHES_SHARDED
    pos = _cuda_pos(pos, "granular kernel")
    dev, n = pos.device, pos.shape[-1]
    sharded = n_local is not None
    n_local = _slice_args(pos, slabs, base, n_local)
    _check(vel, torch.float32, (3, n_local), dev, "vel")
    ptrs, bounds, dims, _keep = _cand_args(slabs, n, dev, n_local)
    prm = params.detach().to(device=dev, dtype=torch.float32).contiguous()
    _check(prm, torch.float32, (6,), dev, "params")
    vel = vel.contiguous()
    pos_out = torch.empty_like(vel)
    vel_out = torch.empty_like(vel)
    if n_local == 0:
        return pos_out, vel_out
    lib = _build.load("granular_step", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.wpe_granular_step(
            prm.data_ptr(), pos.data_ptr(), vel.data_ptr(), *ptrs,
            pos_out.data_ptr(), vel_out.data_ptr(), ctypes.addressof(bounds),
            n, *dims, base, n_local, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "granular_step launch")
    if sharded:
        LAUNCHES_SHARDED += 1
    else:
        LAUNCHES += 1
    return pos_out, vel_out


def _pair_prm(md, kc, dev) -> torch.Tensor:
    md, kc = _md_kc(md, kc, dev)
    return torch.stack([md, kc]).contiguous()


def contact_forces_sorted_kernel(pos: torch.Tensor, md, kc,
                                 slabs: SlabSet) -> torch.Tensor:
    """K11: the pair forces ``[3, n]`` of ``csrc/granular_step.cu``
    (``wpe_granular_forces``, K10's force code) on CUDA tensors, one launch
    on the current stream."""
    global LAUNCHES_FORCES
    pos = _cuda_pos(pos, "granular force kernel")
    dev, n = pos.device, pos.shape[-1]
    ptrs, bounds, dims, _keep = _cand_args(slabs, n, dev)
    prm = _pair_prm(md, kc, dev)
    f = torch.empty_like(pos)
    if n == 0:
        return f
    lib = _build.load("granular_step", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.wpe_granular_forces(
            prm.data_ptr(), pos.data_ptr(), *ptrs, f.data_ptr(),
            ctypes.addressof(bounds), n, *dims,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "granular_forces launch")
    LAUNCHES_FORCES += 1
    return f


def contact_force_jvp_sorted_kernel(pos: torch.Tensor, u: torch.Tensor, md,
                                    kc, slabs: SlabSet) -> torch.Tensor:
    """K12: ``[6, n]``, the pair forces and their directional derivative
    along ``u`` (``wpe_granular_force_jvp``), on CUDA tensors, one launch
    on the current stream."""
    global LAUNCHES_JVP
    pos = _cuda_pos(pos, "granular force-jvp kernel")
    dev, n = pos.device, pos.shape[-1]
    _check(u, torch.float32, (3, n), dev, "u")
    u = u.contiguous()
    ptrs, bounds, dims, _keep = _cand_args(slabs, n, dev)
    prm = _pair_prm(md, kc, dev)
    ft = torch.empty((6, n), dtype=torch.float32, device=dev)
    if n == 0:
        return ft
    lib = _build.load("granular_step", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.wpe_granular_force_jvp(
            prm.data_ptr(), pos.data_ptr(), u.data_ptr(), *ptrs,
            ft.data_ptr(), ctypes.addressof(bounds), n, *dims,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "granular_force_jvp launch")
    LAUNCHES_JVP += 1
    return ft


def _dispatch(pos: torch.Tensor, plain, kernel):
    dev = pos.device.type
    if dev == "cpu":
        return plain
    if dev == "cuda":
        return kernel
    raise ValueError(f"no granular contact kernel for device {pos.device}")


def substep_sorted(pos: torch.Tensor, vel: torch.Tensor, params: torch.Tensor,
                   slabs: SlabSet, base: int = 0,
                   n_local: Optional[int] = None):
    """One substep on sorted state; the drop-in counterpart of
    ``granular_pallas.substep_sorted``, its ``base`` included: with
    ``n_local`` only the slots ``[base, base + n_local)`` are stepped
    (``vel`` theirs, ``pos`` the full array). A CPU tensor takes the plain
    version, a CUDA tensor the kernel (K10, or K10b for a slice); any other
    device raises."""
    step = _dispatch(pos, substep_sorted_plain, substep_sorted_kernel)
    return step(pos, vel, params, slabs, base, n_local)


def contact_forces_sorted(pos: torch.Tensor, md, kc,
                          slabs: SlabSet) -> torch.Tensor:
    """The pair contact forces ``[3, n]`` on sorted ``pos``; the counterpart
    of ``granular_pallas.contact_forces_sorted`` (no pad rows). CPU → the
    plain version, CUDA → K11, any other device raises."""
    fn = _dispatch(pos, contact_forces_sorted_plain,
                   contact_forces_sorted_kernel)
    return fn(pos, md, kc, slabs)


def contact_force_jvp_sorted(pos: torch.Tensor, u: torch.Tensor, md, kc,
                             slabs: SlabSet) -> torch.Tensor:
    """``[6, n]``: the pair forces and ``J·u`` on sorted state; the
    counterpart of ``granular_pallas.contact_force_jvp_sorted`` (no pad
    rows). J is symmetric where no slab entry is dropped (the force is the
    negative gradient of a pair potential, the candidate relation is
    symmetric), so ``u = f̄`` gives the transpose the backward passes
    need. CPU → the plain version, CUDA → K12, any other device raises."""
    fn = _dispatch(pos, contact_force_jvp_sorted_plain,
                   contact_force_jvp_sorted_kernel)
    return fn(pos, u, md, kc, slabs)
