"""Temporal blocking for large cloth grids: K substeps of one world a
launch on tiles held in shared memory (kernel K6), its plain torch
version, its schedule and its dispatch.

The counterpart of ``wgpu_physics_engine_tpu/ops/cloth_pallas_tiled.py``
(``multi_step`` → ``_kernel``, K6), which JAX routes every single-world
grid above ``_VMEM_PARTICLE_LIMIT`` = 100,000 particles to
(``cloth_pallas.py:628-638``); here ``cloth_kernel.multi_step`` routes one
world above :data:`cloth_kernel._TILED_PARTICLE_LIMIT` to :func:`multi_step`.

The grid is cut into tiles of ``tile_h × tile_w`` particles (the core).
A launch loads each core with a halo of ``2k`` particles on all four sides
(the stencil reaches 2 rows and 2 columns a substep), clipped to the grid,
steps it ``k`` substeps with the spring masks taken from grid rows and
columns, and keeps the core. ``n_steps`` substeps take ``⌈n_steps / K⌉``
launches, the last with the remainder, so any ``h``, ``w`` and ``n_steps``
run; JAX's ``h % 8`` and ``(2·K) % 8`` rules were Mosaic DMA tiling and
its fallback to the XLA stencil has no counterpart.

* :func:`multi_step_plain` does the same tile-and-halo decomposition in
  torch: it cuts every core with its halo out of the grid (all tiles at
  once, as a batch; cells beyond the grid are zero), steps the tiles with
  ``cloth_kernel._substep_planes`` under masks built from grid indices
  ("grid validity AND no wrap inside the tile", the two-axis form of
  ``cloth_pallas_tiled.py:84-98``) and keeps the cores. Every kept cell
  equals ``cloth_kernel.multi_step_plain`` bit for bit, which the CPU
  tests check for the halo argument the CUDA kernel relies on (the kernel
  clips a tile at the grid's edge instead of padding it; the cells it
  keeps are the same);
* :func:`multi_step_kernel` launches ``csrc/cloth_tiled.cu`` on a CUDA
  state, ping-ponging between two new buffer pairs (the input is only
  read); its kept cells equal K1's bit for bit. Inside a tile a warp
  sweeps a band of columns down a run of rows and computes each edge
  force once (K1 computes it twice), which is where its speed over K1
  comes from: K1 is not bound by device memory, so the schedule the
  sweep picked is k = 1 (:func:`pick_schedule`);
* :func:`multi_step` takes the plain version for a CPU state and the
  kernel for a CUDA state, and raises for any other device. It is exact:
  ``cloth_kernel.multi_step`` drops ``fast_math`` on this route, as JAX
  drops it on its own;
* :func:`multi_step_window_kernel` (kernel K6w) steps a halo-extended
  band of rows of a larger grid on the same tiles, the spring masks taken
  from global rows: ``cloth_kernel.multi_step_window`` routes a window
  above ``_TILED_PARTICLE_LIMIT`` here (the rows-sharded path's shard body;
  ``cloth_pallas.multi_step_window``, K1w, in JAX). Its plain version is
  the tile decomposition above with K1w's global-row masks
  (:func:`_tile_masks` with a ``window``); every output, the window's
  halo and dead rows included, equals ``cloth_kernel.
  multi_step_window_plain`` (K1w's plain version) bit for bit;
* :func:`multi_step_resident_kernel` (kernel K6r) runs all ``n_steps``
  substeps of one world in one cooperative launch, each CTA holding one
  tile of :func:`resident_schedule` (at most one a multiprocessor) with a
  ring of 2 cells in shared memory for the whole call and exchanging
  2-deep borders with its neighbours through device memory each substep.
  ``cloth_kernel.multi_step`` takes it for a CUDA world above
  ``_TILED_PARTICLE_LIMIT`` whose tiles fit (512², 1024²; 2048² stays on
  K6); its plain version is :func:`multi_step_plain`, the same function;
* :func:`multi_step_batched_kernel_packed` (kernel K5r) steps a batch of
  small worlds, one CTA a world holding it in shared memory for all
  ``n_steps`` substeps, in one launch: K6's walk with the world as its one
  tile. ``cloth_kernel.multi_step_kernel`` takes it for an exact batch of
  worlds that fit (:func:`cloth_kernel.resident_batch`); world i equals K1
  on world i bit for bit.

What fits is worked out from the card: :func:`card` reads its
multiprocessors and the shared memory a CTA can opt in to, once a device,
and :func:`resident_schedule` (K6r) and :func:`batched_fits` (K5r) take
both as arguments, so that the CPU tests reach them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..core.state import ClothParams, ClothState
from . import _build, cloth_kernel
from .cloth_kernel import _FAMILIES, _exact_dist_inv, _substep_planes
from ..utils.profiling import span

# Launches of K6 by :func:`multi_step_kernel` and of K6w by
# :func:`multi_step_window_kernel` (one per ``k_sub`` substeps), of K6r by
# :func:`multi_step_resident_kernel` and of K5r by
# :func:`multi_step_batched_kernel_packed` (one a call).
LAUNCHES = 0
LAUNCHES_WINDOW = 0
LAUNCHES_RESIDENT = 0
LAUNCHES_BATCHED = 0

# The schedule (chosen by a sweep on the card, PERF.md §6): K_SUB
# substeps a launch; tiles TILE_BANDS bands of BAND columns wide (a warp
# of csrc/cloth_tiled.cu steps BAND columns, lanes 2..30), and as many
# rows as fill whole waves of CTAS_PER_SM CTAs on each of SMS
# multiprocessors (the H100 SXM's 132), with at least MIN_TILE_H rows and
# at most as many as SMEM_PER_CTA holds. Three CTAs an SM is what the
# kernel's register bound (__launch_bounds__(256, 3)) and shared memory
# allow.
K_SUB = 1
BAND = 29
TILE_BANDS = 2
MIN_TILE_H = 8
SMS = 132
CTAS_PER_SM = 3
# The shared memory an SM shares out (228 KB), less the 1 KB the card
# keeps for each CTA, over CTAS_PER_SM.
SMEM_PER_CTA = 233_472 // CTAS_PER_SM - 1024
# K6r: the warps of a CTA (csrc/cloth_tiled.cu WPE_K6R_THREADS / 32), the
# most runs of rows (its named barriers) and the ring's depth.
RES_WARPS = 16
RES_MAX_RUNS = 15
RING = 2

_SIGNATURES = {
    "wpe_cloth_tiled_multi_step": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                                  + [ctypes.c_void_p],
    "wpe_cloth_tiled_multi_step_window": [ctypes.c_void_p] * 9
                                         + [ctypes.c_int] * 9
                                         + [ctypes.c_void_p],
    "wpe_cloth_tiled_multi_step_batched": [ctypes.c_void_p] * 7
                                          + [ctypes.c_int] * 5
                                          + [ctypes.c_void_p],
    "wpe_cloth_tiled_multi_step_resident": [ctypes.c_void_p] * 10
                                           + [ctypes.c_int] * 6
                                           + [ctypes.c_void_p],
}

Schedule = Tuple[int, int, int]


def smem_bytes(h: int, w: int, k_sub: int, tile_h: int, tile_w: int) -> int:
    """Shared memory of one CTA: six fp32 planes over the largest extent,
    the core grown by ``2·k_sub`` a side, clipped to the grid; one copy for
    ``k_sub`` = 1, two otherwise."""
    return ((24 if k_sub == 1 else 48) * min(h, tile_h + 4 * k_sub)
            * min(w, tile_w + 4 * k_sub))


def pick_schedule(h: int, w: int, n_steps: int,
                  sms: int = SMS) -> Schedule:
    """``(k_sub, tile_h, tile_w)`` for ``n_steps`` substeps of an ``h × w``
    grid on a card of ``sms`` multiprocessors: :data:`K_SUB` substeps a
    launch (fewer if ``n_steps`` is smaller); the columns cut into tiles of
    at most :data:`TILE_BANDS` bands (less the halo's growth, so every
    substep's region fits them), evened out; the rows into as many tiles
    as fill the fewest whole waves of :data:`CTAS_PER_SM` CTAs an SM,
    evened out, with no tile taller than :data:`SMEM_PER_CTA` holds and
    at most ``⌈h / MIN_TILE_H⌉`` tiles. The counterpart of
    ``cloth_pallas_tiled.pick_schedule``, whose rule (k = 8 if it fits,
    else 16, else 4) was measured on a TPU and does not bind here."""
    k_sub = max(1, min(K_SUB, n_steps))
    cols = -(-w // (TILE_BANDS * BAND - 4 * (k_sub - 1)))
    tile_w = -(-w // cols)
    per_row = (24 if k_sub == 1 else 48) * min(w, tile_w + 4 * k_sub)
    max_h = max(1, SMEM_PER_CTA // per_row - 4 * k_sub)
    slots = sms * CTAS_PER_SM
    rows = -(-h // max_h)
    rows = max(rows, (-(-rows * cols // slots) * slots) // cols)
    rows = min(rows, -(-h // MIN_TILE_H))
    return k_sub, -(-h // rows), tile_w


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def card(device) -> Tuple[int, int]:
    """``(sms, smem)`` of a CUDA ``device``: its multiprocessors and the
    most shared memory one CTA can opt in to, in bytes, asked once a
    device."""
    device = torch.device(device)
    return _card(torch.cuda.current_device() if device.index is None
                 else device.index)


def sm_count(device) -> int:
    """The multiprocessors of a CUDA ``device`` (:func:`card`)."""
    return card(device)[0]


@functools.lru_cache(maxsize=256)
def _card_schedule(h: int, w: int, n_steps: int, sms: int) -> Schedule:
    """:func:`pick_schedule` for a kernel call, computed once a shape and
    card (the module's constants are read at the first call)."""
    return pick_schedule(h, w, n_steps, sms)


def _check_schedule(schedule: Schedule) -> Schedule:
    k_sub, tile_h, tile_w = (int(v) for v in schedule)
    if k_sub < 1 or tile_h < 1 or tile_w < 1:
        raise ValueError(f"schedule (k_sub, tile_h, tile_w) must be >= 1, "
                         f"got {schedule}")
    return k_sub, tile_h, tile_w


def _launches(n_steps: int, k_sub: int):
    """The substeps of each launch: ``k_sub``, the last the remainder."""
    full, rem = divmod(n_steps, k_sub)
    return [k_sub] * full + ([rem] if rem else [])


def _tiles(a: torch.Tensor, k: int, tile_h: int, tile_w: int):
    """``[..., H, W]`` → ``[..., ty, tx, tile_h + 4k, tile_w + 4k]``: every
    core with its halo of ``2k`` a side; cells beyond the grid are 0 (the
    masks of :func:`_tile_masks` never let them act on a grid cell)."""
    h, w = a.shape[-2:]
    ty, tx = -(-h // tile_h), -(-w // tile_w)
    a = torch.nn.functional.pad(
        a, (2 * k, tx * tile_w - w + 2 * k, 2 * k, ty * tile_h - h + 2 * k))
    return (a.unfold(-2, tile_h + 4 * k, tile_h)
            .unfold(-2, tile_w + 4 * k, tile_w))


def _tile_masks(h: int, w: int, k: int, tile_h: int, tile_w: int, device,
                window: Optional[Tuple[int, int]] = None):
    """Validity mask ``[ty, tx, eh, ew]`` per family for the tiles of
    :func:`_tiles`, from grid rows and columns: the anchor and the far end
    of the edge are grid cells, and the far end lies inside the tile
    (no wraparound of ``torch.roll``, whose reaction would otherwise wrap
    onto the tile's first rows or columns). With ``window = (row0,
    h_global)`` the ``[h, w]`` grid is a band of rows of a grid
    ``h_global`` rows high whose row 0 is global row ``row0``, and both
    ends must also be global rows (``cloth_kernel._window_masks``)."""
    ty, tx = -(-h // tile_h), -(-w // tile_w)
    eh, ew = tile_h + 4 * k, tile_w + 4 * k
    lr = torch.arange(eh, device=device)[:, None]
    lc = torch.arange(ew, device=device)[None, :]
    gr = (torch.arange(ty, device=device) * tile_h - 2 * k)[:, None, None,
                                                            None] + lr
    gc = (torch.arange(tx, device=device) * tile_w - 2 * k)[None, :, None,
                                                            None] + lc
    anchor = (gr >= 0) & (gc >= 0) & (gc < w)
    if window is not None:
        anchor = anchor & (gr + window[0] >= 0)
    masks = []
    for dr, dc, _ in _FAMILIES:
        ok = anchor & (gr < h - dr) & (lr < eh - dr)
        if window is not None:
            ok = ok & (gr + window[0] < window[1] - dr)
        if dc >= 0:
            ok = ok & (gc < w - dc) & (lc < ew - dc)
        else:
            ok = ok & (gc >= -dc) & (lc >= -dc)
        masks.append(ok)
    return masks


def multi_step_plain(state: ClothState, params: ClothParams, dt,
                     n_steps: int,
                     schedule: Optional[Schedule] = None) -> ClothState:
    """``n_steps`` exact substeps of one world (``[3, H, W]``) by the tile
    decomposition of K6, on any device. ``schedule`` is ``(k_sub, tile_h,
    tile_w)``, by default :func:`pick_schedule`'s."""
    return multi_step_plain_packed(state, cloth_kernel._pack_params(params, dt),
                                   n_steps, schedule)


def multi_step_plain_packed(state: ClothState, prm: torch.Tensor,
                            n_steps: int,
                            schedule: Optional[Schedule] = None,
                            window: Optional[Tuple[int, int]] = None
                            ) -> ClothState:
    """:func:`multi_step_plain` on the packed vector of
    ``cloth_kernel._pack_params``; with ``window = (row0, h_global)`` the
    state is a row window and the masks K1w's (:func:`_tile_masks`)."""
    if state.pos.ndim != 3:
        raise ValueError(f"the tiled stepper takes one world [3, H, W], got "
                         f"{tuple(state.pos.shape)}")
    h, w = state.pos.shape[-2:]
    if n_steps <= 0 or h * w == 0:
        return state
    k_sub, tile_h, tile_w = _check_schedule(
        schedule or pick_schedule(h, w, n_steps))
    plane = cloth_kernel._plane_params(prm, state)
    pos, vel = state.pos, state.vel
    for k in _launches(n_steps, k_sub):
        masks = _tile_masks(h, w, k, tile_h, tile_w, pos.device, window)
        carry = tuple(_tiles(torch.cat([pos, vel]), k, tile_h, tile_w))
        pins = None
        if state.pin_mask is not None:
            pin = _tiles(state.pin_mask.to(pos.dtype), k, tile_h, tile_w)
            pins = (pin != 0, *_tiles(state.pin_pos, k, tile_h, tile_w))
        for _ in range(k):
            carry = _substep_planes(carry, masks, plane, _exact_dist_inv,
                                    pins)
        # keep the cores: [6, ty, tx, tile_h, tile_w] -> [6, H, W]
        core = torch.stack(carry)[..., 2 * k:2 * k + tile_h,
                                  2 * k:2 * k + tile_w]
        ty, tx = core.shape[1:3]
        core = core.permute(0, 1, 3, 2, 4).reshape(6, ty * tile_h,
                                                   tx * tile_w)[:, :h, :w]
        pos, vel = core[:3].contiguous(), core[3:].contiguous()
    return state._replace(pos=pos, vel=vel)


def multi_step_kernel(state: ClothState, params: ClothParams, dt,
                      n_steps: int,
                      schedule: Optional[Schedule] = None) -> ClothState:
    """``n_steps`` exact substeps of ``csrc/cloth_tiled.cu`` on a CUDA
    state of one world: ``⌈n_steps / k_sub⌉`` launches on the current
    stream into new buffers."""
    return multi_step_kernel_packed(
        state, cloth_kernel._pack_params(params, dt), n_steps, schedule)


def multi_step_kernel_packed(state: ClothState, prm: torch.Tensor,
                             n_steps: int,
                             schedule: Optional[Schedule] = None,
                             window: Optional[Tuple[int, int]] = None
                             ) -> ClothState:
    """:func:`multi_step_kernel` on the packed vector of
    ``cloth_kernel._pack_params``; with ``window = (row0, h_global)`` K6w
    on a row window (``wpe_cloth_tiled_multi_step_window``)."""
    global LAUNCHES, LAUNCHES_WINDOW
    pos, vel, prm, pins, lead, h, w = cloth_kernel._kernel_inputs(state, prm)
    if lead:
        raise ValueError(f"the tiled kernel takes one world [3, H, W], got "
                         f"{tuple(pos.shape)}")
    if window is not None and window[1] < 1:
        raise ValueError(f"h_global must be positive, got {window[1]}")
    if n_steps <= 0 or pos.numel() == 0:
        return state
    sms, smem = card(pos.device)
    k_sub, tile_h, tile_w = _check_schedule(
        schedule or _card_schedule(h, w, n_steps, sms))
    if smem_bytes(h, w, k_sub, tile_h, tile_w) > smem:
        raise ValueError(f"schedule {(k_sub, tile_h, tile_w)} needs "
                         f"{smem_bytes(h, w, k_sub, tile_h, tile_w)} B of "
                         f"shared memory a CTA, more than the card's "
                         f"{smem}")
    pin_ptrs = ((pins[0].data_ptr(), pins[1].data_ptr()) if pins
                else (None, None))
    bufs = torch.empty((4, 3, h, w), dtype=torch.float32, device=pos.device)
    lib = _build.load("cloth_tiled", _SIGNATURES)
    ptrs = (prm.data_ptr(), pos.data_ptr(), vel.data_ptr(), *pin_ptrs,
            bufs[0].data_ptr(), bufs[1].data_ptr(), bufs[2].data_ptr(),
            bufs[3].data_ptr(), h, w, n_steps, k_sub, tile_h, tile_w)
    with torch.cuda.device(pos.device):
        stream = torch.cuda.current_stream().cuda_stream
        if window is None:
            err = lib.wpe_cloth_tiled_multi_step(
                *ptrs, int(pins is not None), stream)
        else:
            err = lib.wpe_cloth_tiled_multi_step_window(
                *ptrs, int(window[0]), int(window[1]), int(pins is not None),
                stream)
    _build.check(lib, err, "cloth_tiled launch")
    n_launch = len(_launches(n_steps, k_sub))
    if window is None:
        LAUNCHES += n_launch
    else:
        LAUNCHES_WINDOW += n_launch
    out = bufs[0:2] if n_launch % 2 else bufs[2:4]
    return state._replace(pos=out[0], vel=out[1])


def multi_step(state: ClothState, params: ClothParams, dt,
               n_steps: int) -> ClothState:
    """``n_steps`` exact substeps of one world by temporal blocking: the
    counterpart of ``cloth_pallas_tiled.multi_step``. A CPU state takes
    the plain version, a CUDA state K6; any other device raises."""
    return multi_step_packed(state, cloth_kernel._pack_params(params, dt),
                             n_steps)


def multi_step_packed(state: ClothState, prm: torch.Tensor,
                      n_steps: int) -> ClothState:
    """:func:`multi_step` on the packed vector of
    ``cloth_kernel._pack_params``."""
    step = cloth_kernel._dispatch(state, multi_step_plain_packed,
                                  multi_step_kernel_packed)
    return step(state, prm, n_steps)


# ---------------------------------------------------------------------------
# K6r: the whole call in one launch, the tiles resident in shared memory
# ---------------------------------------------------------------------------

Tile = Tuple[int, int]


def resident_bytes(h: int, w: int, tile_h: int, tile_w: int) -> int:
    """Shared memory of a K6r CTA: one copy of six fp32 planes over the
    tile grown by :data:`RING` a side, clipped to the grid."""
    return 24 * min(h, tile_h + 2 * RING) * min(w, tile_w + 2 * RING)


def resident_schedule(h: int, w: int, sms: int, smem: int,
                      warps: int = RES_WARPS) -> Optional[Tile]:
    """The tile ``(tile_h, tile_w)`` of K6r for an ``h × w`` grid on a card
    of ``sms`` multiprocessors, or None where no tiling fits: at most one
    tile a multiprocessor (every CTA resident, one an SM), each at least
    2 a side (so that a ring 2 deep comes from the 8 neighbours), at most
    ``warps`` bands wide, and the tile grown by 2 a side in ``smem`` bytes.
    Of those, the tiling whose walk is shortest, counted in rows a warp
    steps: a CTA's warps take (band, run) pairs, bands of :data:`BAND`
    columns across the tile and runs of rows down it, and the walk takes
    the larger of a run's rows and the CTA's band-rows over its warps (a
    run's prologue counts 0.8 row); then the fewest band-rows, then the
    smallest extent. 1024² on the H100 (132 SMs, 232,448 B): 11 × 12 tiles
    of 94 × 86, 211,680 B."""
    best = None
    for tx in range(1, min(sms, w) + 1):
        tile_w = -(-w // tx)
        ty = sms // tx
        if ty < 1:
            break
        tile_h = -(-h // ty)
        bands = -(-tile_w // BAND)
        runs = max(1, min(RES_MAX_RUNS, warps // bands))
        run_h = -(-tile_h // runs)
        if (tile_h < 2 or tile_w < 2 or bands > warps
                or resident_bytes(h, w, tile_h, tile_w) > smem):
            continue
        band_rows = bands * runs * (run_h + 0.8)
        key = (max(run_h + 0.8, band_rows / warps), band_rows,
               resident_bytes(h, w, tile_h, tile_w))
        if best is None or key < best[0]:
            best = (key, (tile_h, tile_w))
    return None if best is None else best[1]


def multi_step_resident_kernel(state: ClothState, params: ClothParams, dt,
                               n_steps: int,
                               tile: Optional[Tile] = None) -> ClothState:
    """``n_steps`` exact substeps of K6r on a CUDA state of one world, in
    one cooperative launch on the current stream into new buffers; on the
    tiles of :func:`resident_schedule` unless ``tile`` is given. Raises
    where the tiles do not fit or the card refuses the launch."""
    return multi_step_resident_kernel_packed(
        state, cloth_kernel._pack_params(params, dt), n_steps, tile)


def multi_step_resident_kernel_packed(state: ClothState, prm: torch.Tensor,
                                      n_steps: int,
                                      tile: Optional[Tile] = None
                                      ) -> ClothState:
    """:func:`multi_step_resident_kernel` on the packed vector of
    ``cloth_kernel._pack_params``."""
    global LAUNCHES_RESIDENT
    pos, vel, prm, pins, lead, h, w = cloth_kernel._kernel_inputs(state, prm)
    if lead:
        raise ValueError(f"the resident kernel takes one world [3, H, W], "
                         f"got {tuple(pos.shape)}")
    if n_steps <= 0 or pos.numel() == 0:
        return state
    smem = card(pos.device)[1]
    tile = tile or resident_tile(h, w, pos.device)
    if tile is None:
        raise ValueError(f"no resident tiling of {h}x{w} fits the card")
    tile_h, tile_w = (int(v) for v in tile)
    if (tile_h < 2 or tile_w < 2 or -(-tile_w // BAND) > RES_WARPS
            or resident_bytes(h, w, tile_h, tile_w) > smem):
        raise ValueError(f"resident tile {tile} of {h}x{w}: each side must "
                         f"be >= 2, at most {RES_WARPS} bands wide, and the "
                         f"tile grown by {RING} within the card's {smem} B")
    tiles = -(-h // tile_h) * -(-w // tile_w)
    pin_ptrs = ((pins[0].data_ptr(), pins[1].data_ptr()) if pins
                else (None, None))
    bufs = torch.empty((4, 3, h, w), dtype=torch.float32, device=pos.device)
    flags = torch.zeros(tiles, dtype=torch.int32, device=pos.device)
    lib = _build.load("cloth_tiled", _SIGNATURES)
    with torch.cuda.device(pos.device):
        err = lib.wpe_cloth_tiled_multi_step_resident(
            prm.data_ptr(), pos.data_ptr(), vel.data_ptr(), *pin_ptrs,
            bufs[0].data_ptr(), bufs[1].data_ptr(), bufs[2].data_ptr(),
            bufs[3].data_ptr(), flags.data_ptr(), h, w, n_steps, tile_h,
            tile_w, int(pins is not None),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "cloth_tiled resident launch")
    LAUNCHES_RESIDENT += 1
    out = bufs[0:2] if n_steps % 2 else bufs[2:4]
    return state._replace(pos=out[0], vel=out[1])


@functools.lru_cache(maxsize=256)
def _card_resident(h: int, w: int, sms: int, smem: int) -> Optional[Tile]:
    return resident_schedule(h, w, sms, smem)


def resident_tile(h: int, w: int, device) -> Optional[Tile]:
    """K6r's tile for one ``h × w`` world on the CUDA ``device``:
    :func:`resident_schedule` on the card's multiprocessors and shared
    memory (:func:`card`), once a shape and card; None where none fits."""
    return _card_resident(h, w, *card(device))


def resident_fits(h: int, w: int, device) -> bool:
    """Whether one ``h × w`` world on the CUDA ``device`` takes K6r."""
    return resident_tile(h, w, device) is not None


# ---------------------------------------------------------------------------
# K5r: a batch of small worlds, one CTA a world for the whole call
# ---------------------------------------------------------------------------

def batched_fits(h: int, w: int, smem: int) -> bool:
    """Whether K5r holds a world of ``h × w`` in one CTA of ``smem``
    bytes of shared memory: two copies of six fp32 planes, 48 B a
    particle (4,842 particles on the H100)."""
    return 48 * h * w <= smem


def multi_step_batched_kernel_packed(state: ClothState, prm: torch.Tensor,
                                     n_steps: int) -> ClothState:
    """``n_steps`` exact substeps of K5r on a CUDA batch ``[B, 3, H, W]``
    and the packed vector of ``cloth_kernel._pack_params`` (``[16]`` or
    ``[B, 16]``): one launch on the current stream, one CTA a world, into
    new buffers (the input is only read)."""
    global LAUNCHES_BATCHED
    with span("cloth.issue"):
        pos, vel, prm, pins, lead, h, w = cloth_kernel._kernel_inputs(state,
                                                                      prm)
        if len(lead) != 1:
            raise ValueError(f"the batched resident kernel takes "
                             f"[B, 3, H, W], got {tuple(pos.shape)}")
        smem = card(pos.device)[1]
        if not batched_fits(h, w, smem) or lead[0] > 65535:
            raise ValueError(f"{lead[0]} worlds of {h}x{w}: K5r takes at most "
                             f"65535 worlds of at most {smem // 48} particles")
        if n_steps <= 0 or pos.numel() == 0:
            return state
        pin_ptrs = ((pins[0].data_ptr(), pins[1].data_ptr()) if pins
                    else (None, None))
        out = torch.empty((2,) + lead + (3, h, w), dtype=torch.float32,
                          device=pos.device)
        lib = _build.load("cloth_tiled", _SIGNATURES)
        with torch.cuda.device(pos.device):
            err = lib.wpe_cloth_tiled_multi_step_batched(
                prm.data_ptr(), pos.data_ptr(), vel.data_ptr(), *pin_ptrs,
                out[0].data_ptr(), out[1].data_ptr(), lead[0], h, w, n_steps,
                int(pins is not None), torch.cuda.current_stream().cuda_stream)
        _build.check(lib, err, "cloth_tiled batched launch")
    LAUNCHES_BATCHED += 1
    return state._replace(pos=out[0], vel=out[1])


# ---------------------------------------------------------------------------
# K6w: a row window of a larger grid on the same tiles
# ---------------------------------------------------------------------------

def multi_step_window_plain(pos, vel, pin_mask, pin_pos, params, dt,
                            n_steps: int, row0: int, h_global: int,
                            schedule: Optional[Schedule] = None):
    """The plain version of K6w: ``n_steps`` exact substeps of the row
    window ``pos``/``vel`` ``[3, h, W]`` (``row0`` the global row of local
    row 0, ``h_global`` the grid's height) by the tile decomposition, on
    any device; the arguments and result of
    ``cloth_kernel.multi_step_window_plain``, which it equals bit for
    bit."""
    return _window_plain_packed(pos, vel, pin_mask, pin_pos,
                                cloth_kernel._pack_params(params, dt),
                                n_steps, row0, h_global, schedule)


def _window_plain_packed(pos, vel, pin_mask, pin_pos, prm: torch.Tensor,
                         n_steps: int, row0: int, h_global: int,
                         schedule: Optional[Schedule] = None):
    """:func:`multi_step_window_plain` on the packed vector of
    ``cloth_kernel._pack_params``."""
    state = ClothState(pos=pos, vel=vel, pin_mask=pin_mask, pin_pos=pin_pos)
    out = multi_step_plain_packed(state, prm, n_steps, schedule,
                                  (row0, h_global))
    return out.pos, out.vel


def multi_step_window_kernel(pos, vel, pin_mask, pin_pos, params, dt,
                             n_steps: int, row0: int, h_global: int,
                             schedule: Optional[Schedule] = None):
    """K6w on a CUDA window: ``⌈n_steps / k_sub⌉`` launches of
    ``csrc/cloth_tiled.cu``'s ``wpe_cloth_tiled_multi_step_window`` on the
    current stream into new buffers (the inputs are only read). Returns
    ``(pos, vel)`` ``[3, h, W]``."""
    return _window_kernel_packed(pos, vel, pin_mask, pin_pos,
                                 cloth_kernel._pack_params(params, dt),
                                 n_steps, row0, h_global, schedule)


def _window_kernel_packed(pos, vel, pin_mask, pin_pos, prm: torch.Tensor,
                          n_steps: int, row0: int, h_global: int,
                          schedule: Optional[Schedule] = None):
    """:func:`multi_step_window_kernel` on the packed vector of
    ``cloth_kernel._pack_params``."""
    state = ClothState(pos=pos, vel=vel, pin_mask=pin_mask, pin_pos=pin_pos)
    out = multi_step_kernel_packed(state, prm, n_steps, schedule,
                                   (row0, h_global))
    return out.pos, out.vel
