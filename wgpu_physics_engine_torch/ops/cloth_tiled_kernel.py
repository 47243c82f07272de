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
* :func:`multi_step_window` (kernel K6w) steps a halo-extended band of
  rows of a larger grid on the same tiles, the spring masks taken from
  global rows: ``cloth_kernel.multi_step_window`` routes a window above
  ``_TILED_PARTICLE_LIMIT`` here (the rows-sharded path's shard body;
  ``cloth_pallas.multi_step_window``, K1w, in JAX). Its plain version is
  the tile decomposition above with K1w's global-row masks
  (:func:`_tile_masks` with a ``window``); every output, the window's
  halo and dead rows included, equals ``cloth_kernel.
  multi_step_window_plain`` (K1w's plain version) bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.state import ClothParams, ClothState
from . import _build, cloth_kernel
from .cloth_kernel import _FAMILIES, _exact_dist_inv, _substep_planes

# Launches of K6 by :func:`multi_step_kernel` and of K6w by
# :func:`multi_step_window_kernel` (one per ``k_sub`` substeps).
LAUNCHES = 0
LAUNCHES_WINDOW = 0

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
# The most dynamic shared memory one CTA can opt in to on the H100.
SMEM_LIMIT = 232_448

_SIGNATURES = {
    "wpe_cloth_tiled_multi_step": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                                  + [ctypes.c_void_p],
    "wpe_cloth_tiled_multi_step_window": [ctypes.c_void_p] * 9
                                         + [ctypes.c_int] * 9
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
    k_sub, tile_h, tile_w = _check_schedule(schedule or pick_schedule(
        h, w, n_steps,
        torch.cuda.get_device_properties(pos.device).multi_processor_count))
    if smem_bytes(h, w, k_sub, tile_h, tile_w) > SMEM_LIMIT:
        raise ValueError(f"schedule {(k_sub, tile_h, tile_w)} needs "
                         f"{smem_bytes(h, w, k_sub, tile_h, tile_w)} B of "
                         f"shared memory a CTA, more than {SMEM_LIMIT}")
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
    state = ClothState(pos=pos, vel=vel, pin_mask=pin_mask, pin_pos=pin_pos)
    out = multi_step_plain_packed(state,
                                  cloth_kernel._pack_params(params, dt),
                                  n_steps, schedule, (row0, h_global))
    return out.pos, out.vel


def multi_step_window_kernel(pos, vel, pin_mask, pin_pos, params, dt,
                             n_steps: int, row0: int, h_global: int,
                             schedule: Optional[Schedule] = None):
    """K6w on a CUDA window: ``⌈n_steps / k_sub⌉`` launches of
    ``csrc/cloth_tiled.cu``'s ``wpe_cloth_tiled_multi_step_window`` on the
    current stream into new buffers (the inputs are only read). Returns
    ``(pos, vel)`` ``[3, h, W]``."""
    state = ClothState(pos=pos, vel=vel, pin_mask=pin_mask, pin_pos=pin_pos)
    out = multi_step_kernel_packed(state,
                                   cloth_kernel._pack_params(params, dt),
                                   n_steps, schedule, (row0, h_global))
    return out.pos, out.vel


def multi_step_window(pos, vel, pin_mask, pin_pos, params, dt,
                      n_steps: int, row0: int, h_global: int):
    """``cloth_kernel.multi_step_window`` on the tiles: CPU → the plain
    version, CUDA → K6w, any other device raises."""
    step = cloth_kernel._dispatch(ClothState(pos=pos, vel=vel),
                                  multi_step_window_plain,
                                  multi_step_window_kernel)
    return step(pos, vel, pin_mask, pin_pos, params, dt, n_steps, row0,
                h_global)
