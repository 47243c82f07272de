"""Instanced-sphere raster: the binning prologue, the two CUDA kernels,
their plain torch versions, and the dispatch between them.

The counterpart of ``wgpu_physics_engine_tpu/ops/raster_pallas.py``. The
tile-binned route (``sphere_raster_tiled`` → ``tiled_prologue`` +
``_tiled_kernel`` (K2) or ``_tiled_kernel_chunked`` (K3)), in its
``return_oc=True`` form:

* :func:`tiled_prologue` projects the centres, bins them by (8, 128)
  screen tile, sorts them stably by tile and builds each tile's four
  candidate ranges — the same (8, 128) bins, sorted order and candidate
  sets as the JAX prologue, so the winners agree bit for bit — and, beside
  them, each sphere's conservative pixel rectangle from the prologue's own
  screen bound (the kernel's cull); :func:`tiled_prologue_batched` does so
  for B worlds in one pass (the counterpart of the JAX datagen's ``vmap``
  of the prologue);
* :func:`work_list` cuts each tile's candidates into chunks and each chunk
  into :data:`SUBS` sub-tiles, the kernel's work items;
* :func:`sphere_raster_kernel` launches ``csrc/sphere_raster.cu``
  (persistent CTAs over the work list, each warp culling the staged
  candidates to its 4×8 pixels, chunks of one tile merged through a
  64-bit (t, index) key; one kernel for any instance count, where the TPU
  needed K3's chunked SMEM table beyond 16,384 instances, and one call
  for a batch of worlds, where the TPU launched per world because Mosaic
  rejects batched SMEM scalars);
* :func:`sphere_raster_plain` sweeps ALL instances in the sorted order, in
  chunks, with the same hit expression and the same first-strict-minimum
  tie rule (world by world for a batch). The binning is conservative (an
  instance outside a tile's ranges hits no pixel of it), so the sweep
  equals the kernel's output;
* :func:`sphere_raster_binned` takes the plain version for a CPU tensor
  and the kernel for a CUDA tensor, and raises for anything else.

Tiles are ceil-divided, so any framebuffer size runs the tiled kernel: the
ragged edge pixels are masked in the kernel.

The untiled route (``sphere_raster`` → ``_kernel``, K4): one world of at
most :data:`MAX_INSTANCES` instances, every pixel against every instance in
id order. The renderer takes it where the JAX renderer does, for a frame
that is not a multiple of (16, 128) (``render.raster.draw_instanced_spheres``):

* :func:`untiled_prologue` builds the eye-relative table ``[4, N]`` in
  instance order;
* :func:`sphere_raster_untiled_kernel` launches
  ``csrc/sphere_raster_untiled.cu``, counted in :data:`LAUNCHES_UNTILED`;
* :func:`sphere_raster_untiled_plain` is the tiled route's plain sweep over
  that table (the first strict minimum in id order);
* :func:`sphere_raster_untiled` dispatches by device as
  :func:`sphere_raster_binned` does.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

TILE_H, TILE_W = 8, 128

# The most instances the untiled route takes: the JAX kernel's SMEM table
# is single-piece (raster_pallas.py:28); larger sets take the tiled route.
MAX_INSTANCES = 16384

# Kernel launches by :func:`sphere_raster_kernel` and by
# :func:`sphere_raster_untiled_kernel`; a run reads them to show that its
# path went through the kernels.
LAUNCHES = 0
LAUNCHES_UNTILED = 0

_SIGNATURES = {
    "wpe_sphere_raster": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
                         + [ctypes.c_void_p],
    "wpe_sphere_raster_plan": [ctypes.c_void_p] + [ctypes.c_int] * 3
                              + [ctypes.c_void_p] * 5,
}
_SIGNATURES_UNTILED = {
    "wpe_sphere_raster_untiled": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p],
}

# pixels × instances per chunk of the plain sweep (bounds its temporaries)
_PLAIN_CHUNK_ELEMS = 1 << 22

# The kernel's work items: SUBS sub-tiles of 8×32 pixels a tile, and the
# fewest candidates of a chunk; the chunk grows with the frame's candidates
# so that the items of a call stay under SUBS · (tiles + max(tiles,
# _EXTRA_ITEMS)), a size the wrapper allocates without reading the device.
SUBS = 4
CHUNK = 1024
_EXTRA_ITEMS = 8192


def tile_grid(h: int, w: int) -> Tuple[int, int]:
    """(tile rows, tile columns) covering an h × w framebuffer."""
    return -(-h // TILE_H), -(-w // TILE_W)


def tiled_prologue_batched(
        camera_rot: torch.Tensor, eye: torch.Tensor, centers: torch.Tensor,
        radius, znear: torch.Tensor, tan_half: torch.Tensor,
        aspect: torch.Tensor, h: int, w: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`tiled_prologue` for B worlds in one pass: ``camera_rot``
    [B, 3, 3], ``eye`` [B, 3], ``centers`` [B, N, 3], ``radius`` a number
    or [B], ``znear``/``tan_half``/``aspect`` [B] (or 0-d, shared).
    Returns ``(wins [B, T, 8] int32, ocb [B, 4, N] f32, order [B, N]
    int32, rect [B, 4, N] int32)``. Each world is binned on its own: a
    stable argsort along the instance axis, one histogram of tile ids per
    world, and every float op elementwise, so world i's tables equal the
    single-world prologue's.

    ``rect`` (sorted order) is each sphere's conservative footprint in
    pixel indices, inclusive: columns ``floor(col - R)`` .. ``ceil(col +
    R)`` and rows ``floor(row - R)`` .. ``ceil(row + R)`` with ``R = 1.5 ·
    r_px + 2``, the reach the binning itself relies on (``fits``: a binned
    sphere's pixels lie within R < 8 of its projected centre, so within
    its tile's ring); the whole frame for a sphere that is not binned.
    The kernel culls with it; the plain sweep ignores it."""
    dev = centers.device
    th, tw = TILE_H, TILE_W
    ty_t, tx_t = tile_grid(h, w)
    n_tiles = ty_t * tx_t
    b, n = centers.shape[0], centers.shape[1]
    f32 = torch.float32

    def per_world(x):
        """A 0-d or [B] value as [B, 1], broadcasting against [B, N]."""
        return torch.as_tensor(x, dtype=f32, device=dev).reshape(-1, 1)

    r = per_world(radius)
    znear, tan_half, aspect = per_world(znear), per_world(tan_half), per_world(aspect)
    rot = camera_rot[:, None]                                  # [B, 1, 3, 3]

    oc = (centers - eye[:, None, :]).to(f32)                   # [B, N, 3] world
    ox, oy, oz = oc.unbind(-1)
    cc = ox * ox + oy * oy + oz * oz - r * r
    # oc @ camera_rotᵀ, written out
    cv = (oc[..., 0:1] * rot[..., 0] + oc[..., 1:2] * rot[..., 1]
          + oc[..., 2:3] * rot[..., 2])                        # [B, N, 3] view
    depth = -cv[..., 2]
    safe = depth > (znear + r)
    d = torch.where(safe, depth, 1.0)
    col = ((cv[..., 0] / d) / (tan_half * aspect) + 1.0) * 0.5 * w - 0.5
    row = (1.0 - (cv[..., 1] / d) / tan_half) * 0.5 * h - 0.5
    # conservative pixel radius: near depth (d - r), scaled by the
    # worst-case off-axis silhouette elongation 1/cos²θ_corner
    elong = 1.0 + tan_half * tan_half * (1.0 + aspect * aspect)
    hf = torch.tensor(float(h), dtype=f32, device=dev)
    wf = torch.tensor(float(w), dtype=f32, device=dev)
    r_px = elong * r / (d - r) * torch.maximum(hf / (2.0 * tan_half),
                                               wf / (2.0 * tan_half * aspect))
    fits = safe & (1.5 * r_px + 2.0 < th)
    tx = torch.clamp(torch.div(col, tw, rounding_mode="floor").to(torch.int32),
                     0, tx_t - 1)
    ty = torch.clamp(torch.div(row, th, rounding_mode="floor").to(torch.int32),
                     0, ty_t - 1)
    tid = torch.where(fits, ty * tx_t + tx, n_tiles).to(torch.int64)

    order = torch.argsort(tid, dim=-1, stable=True)            # [B, N]
    worlds = torch.arange(b, device=dev)[:, None]
    counts = torch.bincount((tid + worlds * (n_tiles + 1)).reshape(-1),
                            minlength=b * (n_tiles + 1)).reshape(b, -1)
    tile_start = torch.cat([torch.zeros((b, 1), dtype=torch.int64, device=dev),
                            torch.cumsum(counts, -1)], dim=-1)  # [B, T + 1]

    # per-tile windows: 3 row-ring ranges (the x-ring is contiguous in the
    # x-minor tile order) + the global range
    tys = torch.arange(ty_t, device=dev)[:, None]
    txs = torch.arange(tx_t, device=dev)[None, :]
    wins = []
    for dy in (-1, 0, 1):
        oky = ((tys + dy >= 0) & (tys + dy < ty_t)).expand(ty_t, tx_t)
        nty = torch.clamp(tys + dy, 0, ty_t - 1)
        x0 = torch.clamp_min(txs - 1, 0)
        x1 = torch.clamp_max(txs + 1, tx_t - 1)
        s = tile_start[:, (nty * tx_t + x0).reshape(-1)]
        e = tile_start[:, (nty * tx_t + x1 + 1).reshape(-1)]
        oky = oky.reshape(-1)
        wins.append(torch.where(oky, s, 0))
        wins.append(torch.where(oky, e, 0))
    wins.append(tile_start[:, n_tiles:n_tiles + 1].expand(b, n_tiles))
    wins.append(torch.full((b, n_tiles), n, dtype=torch.int64, device=dev))
    wins = torch.stack(wins, dim=-1).to(torch.int32)            # [B, T, 8]

    oc_sorted = torch.gather(oc, 1, order[..., None].expand(b, n, 3))
    ocb = torch.cat([oc_sorted.transpose(1, 2),
                     torch.gather(cc, 1, order)[:, None]], dim=1).contiguous()

    reach = 1.5 * r_px + 2.0

    def span(c, size):
        """Inclusive pixel range floor(c - R) .. ceil(c + R), clipped to -1
        .. size; the whole frame where the sphere is not binned."""
        lo = torch.clamp(torch.floor(c - reach), -1.0, size).to(torch.int32)
        hi = torch.clamp(torch.ceil(c + reach), -1.0, size).to(torch.int32)
        return torch.where(fits, lo, 0), torch.where(fits, hi, size - 1)

    rect = torch.stack([*span(col, w), *span(row, h)], dim=1)  # [B, 4, N]
    rect = torch.gather(rect, 2, order[:, None].expand(b, 4, n)).contiguous()
    return wins, ocb, order.to(torch.int32), rect


def tiled_prologue(camera_rot: torch.Tensor, eye: torch.Tensor,
                   centers: torch.Tensor, radius, znear: torch.Tensor,
                   tan_half: torch.Tensor, aspect: torch.Tensor, h: int,
                   w: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project centres, bin by screen tile, sort, and build each tile's
    candidate ranges. Returns ``(wins [T, 8] int32, ocb [4, N] f32,
    order [N] int32, rect [4, N] int32)``: per tile the [start, end)
    ranges of the three row-ring tiles and of the global range, the sorted
    eye-relative centres with ``|oc|² - r²``, the sort permutation, and
    each sorted sphere's conservative pixel rectangle. The first three are
    the JAX prologue's. The batched prologue at one world."""
    wins, ocb, order, rect = tiled_prologue_batched(
        camera_rot[None], eye[None], centers[None], radius, znear, tan_half,
        aspect, h, w)
    return wins[0], ocb[0], order[0], rect[0]


def sphere_raster_plain(ocb: torch.Tensor, dirs: torch.Tensor,
                        znear: torch.Tensor):
    """Brute-force nearest hit over every instance of the sorted table
    ``ocb`` [4, N] for rays ``dirs`` [3, H, W]. Returns ``(tmin [H, W]
    (+inf on a miss), inst [H, W] int32 (sorted index, -1 on a miss),
    oc [3, H, W] (the winner's eye-relative centre, 0 on a miss))``.
    A batch (``ocb`` [B, 4, N], ``dirs`` [B, 3, H, W], ``znear`` [B]) runs
    the sweep world by world and stacks the results."""
    if dirs.ndim == 4:
        zn = torch.as_tensor(znear, device=dirs.device).expand(dirs.shape[0])
        outs = [sphere_raster_plain(o, d, z) for o, d, z in zip(ocb, dirs, zn)]
        return tuple(torch.stack(x) for x in zip(*outs))
    h, w = dirs.shape[-2:]
    if ocb.shape[1] == 0:
        return (torch.full((h, w), float("inf"), device=dirs.device),
                torch.full((h, w), -1, dtype=torch.int32, device=dirs.device),
                torch.zeros((3, h, w), device=dirs.device))
    tmin, inst = _sweep(ocb, dirs, znear)
    hit = inst >= 0
    oc = torch.where(hit[None], ocb[:3, inst.clamp_min(0).reshape(-1).long()]
                     .reshape(3, h, w), 0.0)
    return tmin, inst, oc


def _sweep(ocb: torch.Tensor, dirs: torch.Tensor, znear):
    """Nearest hit of rays ``dirs`` [3, H, W] over the table ``ocb`` [4, N]
    (N > 0) in table order, in chunks: within a chunk the first minimum,
    across chunks only a strict improvement, so the first strict minimum
    in table order wins. Returns ``(tmin [H, W], inst [H, W] int32)``."""
    h, w = dirs.shape[-2:]
    p = h * w
    n = ocb.shape[1]
    d = dirs.reshape(3, p)
    dx, dy, dz = d[0][:, None], d[1][:, None], d[2][:, None]
    tmin = torch.full((p,), float("inf"), dtype=torch.float32, device=d.device)
    inst = torch.full((p,), -1, dtype=torch.int64, device=d.device)
    chunk = max(1, min(n, _PLAIN_CHUNK_ELEMS // max(p, 1)))
    for k0 in range(0, n, chunk):
        o = ocb[:, k0:k0 + chunk]
        b = dx * o[0] + dy * o[1] + dz * o[2]                  # [P, K]
        disc = b * b - o[3]
        t = b - torch.sqrt(torch.clamp_min(disc, 0.0))
        ok = (disc > 0.0) & (t > znear)
        t = torch.where(ok, t, float("inf"))
        tc, kc = torch.min(t, dim=1)                           # first minimum
        better = tc < tmin                                     # strict
        tmin = torch.where(better, tc, tmin)
        inst = torch.where(better, kc + k0, inst)
    return tmin.reshape(h, w), inst.to(torch.int32).reshape(h, w)


def work_list(wins: torch.Tensor, chunk: int = CHUNK):
    """The kernel's work items over ``wins`` ([T, 8] or [B, T, 8]), as its
    first launch (``sphere_raster_plan``) builds them on the device: each
    tile's candidates (its four ranges, in order) cut into chunks of ``c``
    positions, at least one chunk a tile, and each chunk into :data:`SUBS`
    sub-tiles, one item each. ``c`` is ``chunk`` or more, so that the
    items fit ``SUBS · (Q + max(Q, _EXTRA_ITEMS))`` for Q tiles (a chunk
    count ceil(count / c) is at most 1 + count / c). Returns
    ``(item_start [Q + 1] int32, item_tile [SUBS · (Q + max(Q,
    _EXTRA_ITEMS))] int32, c [1] int32)``: the prefix of items a tile
    (world-major), the tile of each item (past the end of the list,
    the last tile) and the chunk. Item k of tile q is sub-tile ``(k -
    item_start[q]) % SUBS`` of chunk ``(k - item_start[q]) // SUBS``."""
    w8 = wins.reshape(-1, 8).long()
    nq = w8.shape[0]
    count = torch.clamp_min(w8[:, 1::2] - w8[:, 0::2], 0).sum(1)     # [Q]
    extra = max(nq, _EXTRA_ITEMS)
    c = torch.clamp_min(_ceil_div(count.sum(), extra), chunk)
    n_chunks = torch.clamp_min(_ceil_div(count, c), 1)
    item_start = torch.nn.functional.pad(torch.cumsum(n_chunks * SUBS, 0),
                                         (1, 0))
    bound = SUBS * (nq + extra)
    ks = torch.arange(bound, device=wins.device)
    item_tile = torch.clamp_max(
        torch.searchsorted(item_start, ks, right=True) - 1, max(nq - 1, 0))
    return (item_start.to(torch.int32), item_tile.to(torch.int32),
            c.reshape(1).to(torch.int32))


def _plan_buffers(nq: int, dev):
    """``(item_start, item_tile, chunk, scratch)`` for the work list of nq
    tiles (see ``csrc/sphere_raster.cu``), and ``extra``."""
    extra = max(nq, _EXTRA_ITEMS)
    i32 = dict(dtype=torch.int32, device=dev)
    return (torch.empty(nq + 1, **i32),
            torch.empty(SUBS * (nq + extra), **i32), torch.empty(1, **i32),
            torch.empty(4 + nq + -(-nq // 1024), **i32), extra)


def work_list_kernel(wins: torch.Tensor):
    """:func:`work_list` built on the card by the raster's first launches;
    ``item_tile`` is written only up to ``item_start[-1]``."""
    if wins.device.type != "cuda" or wins.dtype != torch.int32:
        raise ValueError(f"work_list_kernel needs int32 CUDA bins, got "
                         f"{wins.dtype} on {wins.device}")
    w8 = wins.reshape(-1, 8).contiguous()
    nq = w8.shape[0]
    item_start, item_tile, chunk, scratch, extra = _plan_buffers(
        nq, wins.device)
    lib = _build.load("sphere_raster", _SIGNATURES)
    with torch.cuda.device(wins.device):
        err = lib.wpe_sphere_raster_plan(
            w8.data_ptr(), nq, CHUNK, extra, item_start.data_ptr(),
            item_tile.data_ptr(), chunk.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sphere_raster_plan launch")
    return item_start, item_tile, chunk


def _ceil_div(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a + b - 1, b, rounding_mode="floor")


def sphere_raster_kernel(wins: torch.Tensor, ocb: torch.Tensor,
                         rect: torch.Tensor, dirs: torch.Tensor,
                         znear: torch.Tensor):
    """``csrc/sphere_raster.cu`` on CUDA tensors; same outputs as
    :func:`sphere_raster_plain`. One world (``wins`` [T, 8], ``ocb`` and
    ``rect`` [4, N], ``dirs`` [3, H, W], ``znear`` 0-d) or a batch (a
    leading [B] on each, ``znear`` [B] or shared) in one call over the
    :func:`work_list` of the batch (launches on the current stream: four
    for the work list, the merge keys, the persistent sweep, the merge)."""
    global LAUNCHES
    dev = dirs.device
    if dev.type != "cuda":
        raise ValueError(f"raster kernel needs CUDA tensors, got {dev}")
    batched = dirs.ndim == 4
    lead = tuple(dirs.shape[:1]) if batched else ()
    h, w = dirs.shape[-2:]
    ty_t, tx_t = tile_grid(h, w)
    n = ocb.shape[-1]
    if (dirs.dtype != torch.float32 or tuple(dirs.shape) != lead + (3, h, w)
            or ocb.dtype != torch.float32 or tuple(ocb.shape) != lead + (4, n)
            or rect.dtype != torch.int32 or tuple(rect.shape) != lead + (4, n)
            or wins.dtype != torch.int32
            or tuple(wins.shape) != lead + (ty_t * tx_t, 8)
            or ocb.device != dev or wins.device != dev
            or rect.device != dev):
        raise ValueError("sphere_raster_kernel: expected dirs f32 [B?, 3, H, "
                         "W], ocb f32 and rect i32 [B?, 4, N], wins i32 [B?, "
                         f"tiles, 8] on one device; got {tuple(dirs.shape)} "
                         f"{tuple(ocb.shape)} {tuple(rect.shape)} {rect.dtype} "
                         f"{tuple(wins.shape)} {wins.dtype} on {dirs.device} "
                         f"{ocb.device} {rect.device} {wins.device}")
    n_worlds = lead[0] if batched else 1
    dirs, ocb, wins = dirs.contiguous(), ocb.contiguous(), wins.contiguous()
    rect = rect.contiguous()
    zn = torch.as_tensor(znear, dtype=torch.float32, device=dev)
    zn = zn.expand(lead).reshape(n_worlds).contiguous()
    tmin = torch.empty(lead + (h, w), dtype=torch.float32, device=dev)
    inst = torch.empty(lead + (h, w), dtype=torch.int32, device=dev)
    oc = torch.empty(lead + (3, h, w), dtype=torch.float32, device=dev)
    if n_worlds == 0 or h * w == 0:
        return tmin, inst, oc
    item_start, item_tile, chunk, scratch, extra = _plan_buffers(
        n_worlds * ty_t * tx_t, dev)
    keys = torch.empty(lead + (h, w), dtype=torch.int64, device=dev)
    lib = _build.load("sphere_raster", _SIGNATURES)
    with torch.cuda.device(dev):
        err = lib.wpe_sphere_raster(
            zn.data_ptr(), wins.data_ptr(), ocb.data_ptr(), rect.data_ptr(),
            dirs.data_ptr(), item_start.data_ptr(), item_tile.data_ptr(),
            chunk.data_ptr(), scratch.data_ptr(), keys.data_ptr(),
            tmin.data_ptr(), inst.data_ptr(), oc.data_ptr(), n_worlds, n, h,
            w, ty_t, tx_t, CHUNK, extra,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sphere_raster launch")
    LAUNCHES += 1
    return tmin, inst, oc


def sphere_raster_binned(wins: torch.Tensor, ocb: torch.Tensor,
                         rect: torch.Tensor, dirs: torch.Tensor,
                         znear: torch.Tensor):
    """``(tmin, inst, oc)`` from prebuilt bins, for one world or a batch:
    the plain version for a CPU tensor, the kernel for a CUDA tensor; any
    other device raises."""
    dev = dirs.device.type
    if dev == "cpu":
        return sphere_raster_plain(ocb, dirs, znear)
    if dev == "cuda":
        return sphere_raster_kernel(wins, ocb, rect, dirs, znear)
    raise ValueError(f"no sphere raster for device {dirs.device}")


def sphere_raster_tiled(camera_rot: torch.Tensor, eye: torch.Tensor,
                        dirs: torch.Tensor, centers: torch.Tensor, radius,
                        znear: torch.Tensor, tan_half: torch.Tensor,
                        aspect: torch.Tensor):
    """Tile-binned nearest ray-sphere hit: ``(tmin [H, W], hit [H, W]
    bool, oc [3, H, W])`` — the JAX ``sphere_raster_tiled(...,
    return_oc=True)`` contract. ``camera_rot`` [3, 3] world→view,
    ``dirs`` [3, H, W] normalized world rays, ``centers`` [N, 3]."""
    h, w = dirs.shape[-2:]
    wins, ocb, _, rect = tiled_prologue(camera_rot, eye, centers, radius,
                                        znear, tan_half, aspect, h, w)
    tmin, inst, oc = sphere_raster_binned(wins, ocb, rect, dirs, znear)
    return tmin, inst >= 0, oc


def untiled_prologue(eye: torch.Tensor, centers: torch.Tensor,
                     radius) -> torch.Tensor:
    """The untiled route's table ``ocb`` [4, N] in instance order: the
    eye-relative centres and ``|oc|² - r²`` (JAX ``sphere_raster``
    :76-78), computed once for the kernel and its plain version alike."""
    oc = (centers - eye[None, :]).to(torch.float32)             # [N, 3]
    ox, oy, oz = oc.unbind(-1)
    r = torch.as_tensor(radius, dtype=torch.float32, device=oc.device)
    return torch.stack([ox, oy, oz, ox * ox + oy * oy + oz * oz - r * r])


def sphere_raster_untiled_plain(ocb: torch.Tensor, dirs: torch.Tensor,
                                znear: torch.Tensor):
    """Nearest hit over every instance of ``ocb`` [4, N] for rays ``dirs``
    [3, H, W]: ``(tmin [H, W] (+inf on a miss), inst [H, W] int32 (the
    instance id, -1 on a miss))``, ties to the lower id. The plain version
    of :func:`sphere_raster_untiled_kernel`."""
    return sphere_raster_plain(ocb, dirs, znear)[:2]


def sphere_raster_untiled_kernel(ocb: torch.Tensor, dirs: torch.Tensor,
                                 znear: torch.Tensor):
    """``csrc/sphere_raster_untiled.cu`` on CUDA tensors; the outputs of
    :func:`sphere_raster_untiled_plain`. One world: ``ocb`` [4, N] with N <=
    :data:`MAX_INSTANCES`, ``dirs`` [3, H, W], ``znear`` 0-d."""
    global LAUNCHES_UNTILED
    dev = dirs.device
    if dev.type != "cuda":
        raise ValueError(f"raster kernel needs CUDA tensors, got {dev}")
    h, w = dirs.shape[-2:]
    n = ocb.shape[-1]
    if (dirs.dtype != torch.float32 or tuple(dirs.shape) != (3, h, w)
            or ocb.dtype != torch.float32 or tuple(ocb.shape) != (4, n)
            or ocb.device != dev or n > MAX_INSTANCES):
        raise ValueError("sphere_raster_untiled_kernel: expected dirs f32 "
                         f"[3, H, W], ocb f32 [4, N <= {MAX_INSTANCES}] on "
                         f"one device; got {tuple(dirs.shape)} {dirs.dtype} "
                         f"{tuple(ocb.shape)} {ocb.dtype} on {dirs.device} "
                         f"{ocb.device}")
    dirs, ocb = dirs.contiguous(), ocb.contiguous()
    zn = torch.as_tensor(znear, dtype=torch.float32, device=dev).reshape(1)
    tmin = torch.empty((h, w), dtype=torch.float32, device=dev)
    inst = torch.empty((h, w), dtype=torch.int32, device=dev)
    if h * w == 0:
        return tmin, inst
    lib = _build.load("sphere_raster_untiled", _SIGNATURES_UNTILED)
    with torch.cuda.device(dev):
        err = lib.wpe_sphere_raster_untiled(
            zn.data_ptr(), ocb.data_ptr(), dirs.data_ptr(), tmin.data_ptr(),
            inst.data_ptr(), n, h, w, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sphere_raster_untiled launch")
    LAUNCHES_UNTILED += 1
    return tmin, inst


def sphere_raster_untiled(eye: torch.Tensor, dirs: torch.Tensor,
                          centers: torch.Tensor, radius, znear: torch.Tensor):
    """Untiled nearest ray-sphere hit — the JAX ``sphere_raster`` contract:
    ``eye`` [3], ``dirs`` [3, H, W] normalized, ``centers`` [N, 3] with N <=
    :data:`MAX_INSTANCES`; returns ``(tmin [H, W], inst [H, W] int32)``,
    +inf and -1 on a miss. The plain version for a CPU tensor, the kernel
    for a CUDA tensor; any other device raises."""
    n = centers.shape[0]
    assert n <= MAX_INSTANCES, f"{n} instances exceed {MAX_INSTANCES}"
    ocb = untiled_prologue(eye, centers, radius)
    dev = dirs.device.type
    if dev == "cpu":
        return sphere_raster_untiled_plain(ocb, dirs, znear)
    if dev == "cuda":
        return sphere_raster_untiled_kernel(ocb, dirs, znear)
    raise ValueError(f"no sphere raster for device {dirs.device}")
