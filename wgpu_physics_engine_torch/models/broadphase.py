"""Sort-based uniform-grid broad phase (BASELINE configs[2]/[3]): the
counterpart of ``wgpu_physics_engine_tpu/models/broadphase.py``, in eager
torch.

1. quantize positions to cells and linearize them to cell ids;
2. sort the particles stably by cell id (:func:`build_sorted_grid`, the
   structure the granular kernel consumes) or scatter them into a
   fixed-capacity bucket table (:func:`build_table`);
3. answer neighbour queries with the 27 neighbour cells, or with the 9
   (dx, dy) column groups whose z-triples are one contiguous window of the
   sorted order each (:func:`group_window_ranges`).

Every output equals the JAX package's bit for bit: the same stable sort
(so the same permutation), the same integer arithmetic, the same
histogram-plus-exclusive-cumsum ``cell_start``. Cell coordinates divide by
a device tensor, never by a Python float, so the division is a true fp32
division on every device (a CUDA tensor divided by a host scalar becomes a
multiply by its reciprocal).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

_I32 = torch.int32
_F32 = torch.float32


def _safe_norm(d2: torch.Tensor) -> torch.Tensor:
    """sqrt(d2) with a finite backward pass at d2 = 0 (primal identical:
    sqrt(0) = 0); self and invalid candidate slots gather coincident
    positions."""
    pos = d2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, d2, 1.0)), 0.0)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static uniform-grid description. ``cell_size`` must be ≥ the
    interaction diameter for 27-cell completeness."""

    origin: Tuple[float, float, float]
    cell_size: float
    dims: Tuple[int, int, int]       # cells per axis
    capacity: int = 8                # max particles per cell

    @property
    def num_cells(self) -> int:
        return self.dims[0] * self.dims[1] * self.dims[2]


def cell_coords(pos: torch.Tensor, spec: GridSpec, origin=None) -> torch.Tensor:
    """Integer cell coordinates ``[3, N]`` (int32), clipped to the grid.
    ``origin`` may be a ``[3]`` tensor (a grid that follows the object's
    bounding box); defaults to the static ``spec.origin``."""
    dev = pos.device
    if origin is None:
        origin = torch.tensor(spec.origin, dtype=_F32, device=dev)
    cell = torch.tensor(spec.cell_size, dtype=_F32, device=dev)
    c = torch.floor((pos - origin.to(dev)[:, None]) / cell).to(_I32)
    dims = torch.tensor(spec.dims, dtype=_I32, device=dev)[:, None]
    return torch.minimum(torch.clamp_min(c, 0), dims - 1)


def cell_ids(pos: torch.Tensor, spec: GridSpec, origin=None) -> torch.Tensor:
    """Linear cell id per particle (int32 ``[N]``). ``pos``: [3, N]."""
    c = cell_coords(pos, spec, origin)
    return (c[0] * spec.dims[1] + c[1]) * spec.dims[2] + c[2]


def build_table(pos: torch.Tensor, spec: GridSpec, origin=None,
                return_stats: bool = False):
    """Bucket table ``[num_cells, capacity]`` of particle indices (-1 =
    empty). Within a cell, particles appear in index order (the sort is
    stable); overflow beyond ``capacity`` is dropped. With
    ``return_stats=True`` also returns the dropped-particle count (int32
    0-d tensor)."""
    n = pos.shape[-1]
    dev = pos.device
    cid = cell_ids(pos, spec, origin)
    sorted_cid, order = torch.sort(cid, stable=True)
    iota = torch.arange(n, dtype=_I32, device=dev)
    is_first = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                          sorted_cid[1:] != sorted_cid[:-1]])
    first = torch.cummax(torch.where(is_first, iota, 0), 0).values
    rank = iota - first
    slot = sorted_cid * spec.capacity + rank
    keep = rank < spec.capacity
    # overflow entries go to one extra bucket past the table, cut off below
    size = spec.num_cells * spec.capacity
    slot = torch.where(keep, slot, size)
    table = torch.full((size + 1,), -1, dtype=_I32, device=dev)
    table[slot.long()] = order.to(_I32)
    table = table[:size].reshape(spec.num_cells, spec.capacity)
    if return_stats:
        return table, (~keep).sum().to(_I32)
    return table


_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]

# 9 (dx, dy) offset groups; each covers the z-contiguous cell triple
# [dz-1, dz, dz+1] as ONE sorted-array window.
OFFSETS_XY = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def group_window_ranges(c: torch.Tensor, spec: GridSpec,
                        cell_start: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sorted-array window ranges of the 9 (dx, dy) neighbour-column
    groups.

    ``c``: [3, N] integer cell coords (already clipped to the grid).
    Returns ``(starts [N, 9], ends [N, 9], okxy [N, 9])``: group ``g``'s
    candidates for particle ``i`` are the sorted slots ``[starts[i, g],
    ends[i, g])`` (the z-triple window), and ``okxy[i, g]`` is False when
    the group's (x, y) column lies outside the grid (the clamped range is
    then meaningless and must be masked or replaced by the caller). The
    single source of the window derivation of :func:`pair_forces_sorted`,
    :func:`build_candidates` and ``ops.granular_kernel.build_windows``."""
    d0, d1, d2 = spec.dims
    ncz0 = torch.clamp_min(c[2] - 1, 0)
    zspan = torch.clamp_max(c[2] + 2, d2) - ncz0        # 2 or 3 cells
    starts, ends, oks = [], [], []
    for dx, dy in OFFSETS_XY:
        okxy = ((c[0] + dx >= 0) & (c[0] + dx < d0)
                & (c[1] + dy >= 0) & (c[1] + dy < d1))
        ncx = torch.clamp(c[0] + dx, 0, d0 - 1)
        ncy = torch.clamp(c[1] + dy, 0, d1 - 1)
        c0 = ((ncx * d1 + ncy) * d2 + ncz0).long()
        starts.append(cell_start[c0])
        ends.append(cell_start[c0 + zspan])
        oks.append(okxy)
    return (torch.stack(starts, dim=-1), torch.stack(ends, dim=-1),
            torch.stack(oks, dim=-1))


class SortedGrid(NamedTuple):
    """Particles reordered by cell id plus per-cell range starts: each of
    the 9 (dx, dy) groups' candidates form one contiguous range
    ``[cell_start[c0], cell_start[c0 + 3])`` of the sorted order."""

    order: torch.Tensor        # [N] int32 original index of sorted slot
    sorted_cid: torch.Tensor   # [N] int32
    cell_start: torch.Tensor   # [num_cells + 3] int32 first slot of a cell
    sorted_pos: torch.Tensor   # [3, N]
    sorted_vel: torch.Tensor   # [3, N]


def build_sorted_grid(pos: torch.Tensor, vel: torch.Tensor, spec: GridSpec,
                      origin=None) -> SortedGrid:
    """One stable sort by cell id, the state planes gathered by its
    permutation (the JAX package carries them through one multi-operand
    sort: the same permutation, the same values). ``cell_start[c]`` is the
    number of particles with cid < c, a histogram and an exclusive cumsum,
    with two trailing ``n`` entries so that the window end of the last z
    cells (``c0 + zspan`` up to ``num_cells + 2``) stays in range."""
    n = pos.shape[-1]
    dev = pos.device
    cid = cell_ids(pos, spec, origin)
    sorted_cid, order = torch.sort(cid, stable=True)
    counts = torch.bincount(sorted_cid.long(),
                            minlength=spec.num_cells)[:spec.num_cells]
    cell_start = torch.cat([
        torch.zeros((1,), dtype=_I32, device=dev),
        torch.cumsum(counts, 0).to(_I32),
        torch.full((2,), n, dtype=_I32, device=dev),
    ])
    return SortedGrid(order=order.to(_I32), sorted_cid=sorted_cid,
                      cell_start=cell_start, sorted_pos=pos[:, order],
                      sorted_vel=vel[:, order])


def _inverse(order: torch.Tensor) -> torch.Tensor:
    """The inverse permutation (the JAX package's stable argsort of a
    permutation, which is the same array)."""
    inv = torch.empty_like(order, dtype=torch.long)
    inv[order.long()] = torch.arange(order.shape[0], device=order.device)
    return inv


def pair_forces_sorted(grid: SortedGrid, spec: GridSpec, radius, k_contact,
                       window: int, origin=None,
                       return_stats: bool = False):
    """Pairwise penalty contact on the sorted structure, returned in
    ORIGINAL particle order ``[3, N]``. ``window`` bounds the candidates
    taken per (dx, dy) group; extras beyond it are dropped. With
    ``return_stats=True`` also returns the dropped-candidate count (int32
    0-d tensor, summed over particles and groups)."""
    pos = grid.sorted_pos
    n = pos.shape[-1]
    dev = pos.device
    c = cell_coords(pos, spec, origin)
    min_dist = 2.0 * torch.as_tensor(radius, dtype=_F32, device=dev)
    slot_self = torch.arange(n, device=dev)
    k_idx = torch.arange(window, device=dev)
    g_starts, g_ends, g_ok = group_window_ranges(c, spec, grid.cell_start)
    force = torch.zeros_like(pos)
    dropped = torch.zeros((), dtype=_I32, device=dev)
    for g in range(len(OFFSETS_XY)):
        start, end, okxy = g_starts[:, g], g_ends[:, g], g_ok[:, g]
        dropped = dropped + torch.where(
            okxy, torch.clamp_min(end - start - window, 0), 0).sum().to(_I32)
        idx = start[:, None].long() + k_idx[None, :]          # [N, window]
        valid = (idx < end[:, None]) & okxy[:, None]
        idx = torch.clamp(idx, 0, n - 1)
        valid = valid & (idx != slot_self[:, None])
        d = pos[:, :, None] - pos[:, idx]                     # [3, N, window]
        dist = _safe_norm(torch.sum(d * d, dim=0))
        touching = valid & (dist < min_dist) & (dist > 1e-6)
        inv = 1.0 / torch.where(dist > 1e-6, dist, 1.0)
        f = torch.where(touching[None],
                        (k_contact * (min_dist - dist) * inv)[None] * d, 0.0)
        force = force + torch.sum(f, dim=2)
    force = force[:, _inverse(grid.order)]
    if return_stats:
        return force, dropped
    return force


def build_candidates(grid: SortedGrid, spec: GridSpec, r_query,
                     window: int, max_neighbors: int, origin=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Verlet candidate list in SORTED order: for each sorted slot, up to
    ``max_neighbors`` other slots within ``r_query``, kept in window-scan
    order (the rebuild-every-K broad phase of the gather route).

    Returns ``(idx [N, M] int32, mask [N, M] bool, dropped int32)``, where
    ``dropped`` counts true candidates lost to ``window`` or
    ``max_neighbors`` truncation. The compaction is the JAX package's: M
    argmin-extraction sweeps over the ``[N, 9·window]`` key matrix, the
    first minimum winning, so the lists are equal bit for bit."""
    pos = grid.sorted_pos
    n = pos.shape[-1]
    dev = pos.device
    m = max_neighbors
    c = cell_coords(pos, spec, origin)
    rq = torch.tensor(r_query, dtype=_F32, device=dev)
    r2 = rq * rq
    slot_self = torch.arange(n, device=dev)
    k_idx = torch.arange(window, device=dev)
    big = 1 << 30

    keys, idxs = [], []
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    g_starts, g_ends, g_ok = group_window_ranges(c, spec, grid.cell_start)
    for g in range(len(OFFSETS_XY)):
        start, end, okxy = g_starts[:, g], g_ends[:, g], g_ok[:, g]
        idx = start[:, None].long() + k_idx[None, :]          # [N, window]
        valid = (idx < end[:, None]) & okxy[:, None]
        idxc = torch.clamp(idx, 0, n - 1)
        valid = valid & (idxc != slot_self[:, None])
        d = pos[:, :, None] - pos[:, idxc]
        valid = valid & (torch.sum(d * d, dim=0) < r2)
        # window overflow: candidates past the window are unseen, count
        # them all (conservative: some might fail the radius test)
        over = torch.clamp_min(end - start - window, 0)
        dropped = dropped + torch.where(okxy, over, 0).sum()
        rank = g * window + k_idx
        keys.append(torch.where(valid, rank[None, :].to(_I32), big))
        idxs.append(idxc.to(_I32))
    key = torch.cat(keys, dim=1)                              # [N, 9W]
    idx = torch.cat(idxs, dim=1)
    cols = torch.arange(key.shape[1], device=dev)[None, :]
    out_idx, out_key = [], []
    for _ in range(m):
        amin = torch.argmin(key, dim=1)[:, None]
        out_key.append(torch.gather(key, 1, amin)[:, 0])
        out_idx.append(torch.gather(idx, 1, amin)[:, 0])
        key = torch.where(cols == amin, big, key)
    dropped = dropped + (key < big).sum()     # valid candidates beyond M
    out_idx = torch.stack(out_idx, dim=1)
    out_key = torch.stack(out_key, dim=1)
    return out_idx, out_key < big, dropped.to(_I32)


def pair_forces(pos: torch.Tensor, vel: torch.Tensor, table: torch.Tensor,
                spec: GridSpec, radius, k_contact, origin=None) -> torch.Tensor:
    """Pairwise sphere penalty contact through the bucket table: for each
    particle, ``k_contact · overlap · n̂`` summed over neighbours within
    ``2·radius`` over the 27 cell offsets. Returns force [3, N]."""
    n = pos.shape[-1]
    dev = pos.device
    c = cell_coords(pos, spec, origin)
    dims = torch.tensor(spec.dims, dtype=_I32, device=dev)[:, None]
    min_dist = 2.0 * torch.tensor(radius, dtype=_F32, device=dev)
    idx_self = torch.arange(n, device=dev)
    force = torch.zeros_like(pos)
    for off in _OFFSETS:
        nc = c + torch.tensor(off, dtype=_I32, device=dev)[:, None]
        in_grid = torch.all((nc >= 0) & (nc < dims), dim=0)
        ncid = (nc[0] * spec.dims[1] + nc[1]) * spec.dims[2] + nc[2]
        ncid = torch.where(in_grid, ncid, 0)
        cand = table[ncid.long()].long()                      # [N, cap]
        valid = ((cand >= 0) & in_grid[:, None]
                 & (cand != idx_self[:, None]))
        cand_safe = torch.where(valid, cand, 0)
        d = pos[:, :, None] - pos[:, cand_safe]               # [3, N, cap]
        dist = _safe_norm(torch.sum(d * d, dim=0))
        touching = valid & (dist < min_dist) & (dist > 1e-6)
        inv = 1.0 / torch.where(dist > 1e-6, dist, 1.0)
        overlap = min_dist - dist
        f = torch.where(touching[None],
                        (k_contact * overlap * inv)[None] * d, 0.0)
        force = force + torch.sum(f, dim=2)
    return force
