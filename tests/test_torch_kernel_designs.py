"""The host-side parts of the kernels' designs, on the CPU: the sphere
raster's conservative pixel rectangles and work list (K2/K3), and the
pair-force walk's lane split (K10–K12).

* The prologue's ``rect`` planes leave its JAX outputs as they were:
  ``wins`` and ``order`` equal JAX's ``tiled_prologue`` bit for bit and
  ``ocb`` within 1e-6 (XLA contracts the projection's products into FMA;
  ``tests/test_torch_render.py``), on the flagship's draped cloth and on
  randomized datagen cameras.
* The rectangles are conservative: every (pixel, sphere) pair whose ray
  test passes (``disc > 0`` and ``t > znear``, the sweep's own test) lies
  inside that sphere's rectangle, so the kernel's cull drops no hit.
* The work list covers every (tile, sub-tile, candidate) once, in
  candidate order, and fits the buffer the wrapper allocates.
* A CPU mirror of the kernel's algorithm (items, per-warp cull, first
  strict minimum, the 64-bit key merge across chunks) equals the plain
  full sweep bit for bit, exact-t ties across chunk boundaries included.
* A mirror of the walk's summation order (lane l of L sums the window's
  slots l, l + L, ... in double, a butterfly merges the lanes, one
  rounding a group) equals ``contact_forces_sorted_plain`` bit for bit on
  a thin self-collision set: a group's sum in double rounds once, so its
  order does not matter but at a rounding tie (none on this data).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu import render as JR
from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.ops import raster_pallas
from wgpu_physics_engine_torch import render as TR
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.core import state as tstate
from wgpu_physics_engine_torch.models import cloth as tcloth
from wgpu_physics_engine_torch.ops import cloth_kernel
from wgpu_physics_engine_torch.ops import granular_kernel as gk
from wgpu_physics_engine_torch.ops import raster_kernel as rk
from wgpu_physics_engine_torch.parallel import datagen as TD

DT = 1.0 / 480.0
GRID = 32
# spheres drawn larger than the 32² cloth's own 0.1, so that they cover
# pixels at these small frames
RADIUS = 0.35


def _np(x):
    return x.detach().cpu().numpy()


@pytest.fixture(scope="module")
def draped():
    """The flagship cloth at 32², dropped 2.75 s onto the globe."""
    c = tcfg.ClothConfig(height=GRID, width=GRID)
    p = tstate.ClothParams.from_config(c, device="cpu")
    s = cloth_kernel.multi_step_plain(
        tstate.init_cloth_state(c, device="cpu"), p, DT, 1320)
    centers = s.pos.reshape(3, -1).T.contiguous()
    assert float(torch.linalg.norm(centers, dim=1).min()) < 10.2
    return centers, RADIUS


def _with_strays(centers, seed):
    """The cloth plus spheres the binning sends to the global range:
    behind and just in front of a camera on the z axis, and one large."""
    rng = np.random.default_rng(seed)
    extra = np.concatenate([rng.uniform(-12, 12, (40, 3)),
                            [[0.0, 0.0, 40.0], [0.0, 0.0, 39.95],
                             [0.0, 0.0, 45.0], [0.0, 2.0, 30.0]]])
    return torch.cat([centers, torch.tensor(extra, dtype=torch.float32)])


def _flagship_view(h, w):
    """JAX's and the port's flagship camera (the same values)."""
    jc = JR.make_camera(jcfg.CameraConfig(target=(0.0, 5.0, 0.0),
                                          radius=24.0, phi=0.5),
                        aspect=w / h)
    tc = TR.Camera(*(torch.tensor(np.asarray(a)) for a in jc))
    return jc, tc


def _hits_inside_rect(ocb, rect, dirs, znear):
    """Every (pixel, sphere) pair the sweep's ray test passes lies inside
    that sphere's rectangle; returns the number of such pairs."""
    h, w = dirs.shape[-2:]
    d = dirs.reshape(3, -1)
    b = d[0][:, None] * ocb[0] + d[1][:, None] * ocb[1] + d[2][:, None] * ocb[2]
    disc = b * b - ocb[3]
    t = b - torch.sqrt(torch.clamp_min(disc, 0.0))
    hit = (disc > 0.0) & (t > znear)                         # [P, N]
    col = torch.arange(h * w) % w
    row = torch.arange(h * w) // w
    inside = ((col[:, None] >= rect[0]) & (col[:, None] <= rect[1])
              & (row[:, None] >= rect[2]) & (row[:, None] <= rect[3]))
    bad = hit & ~inside
    assert not bool(bad.any()), torch.nonzero(bad)[:5]
    return int(hit.sum())


@pytest.mark.parametrize("hw", [(48, 256), (40, 200)])
def test_rect_leaves_prologue_and_is_conservative_flagship(draped, hw):
    h, w = hw
    centers = _with_strays(draped[0], 1)
    radius = draped[1]
    jc, tc = _flagship_view(h, w)
    tan = torch.tan(tc.fovy_rad / 2.0)
    wins, ocb, order, rect = rk.tiled_prologue(
        tc.view[:3, :3], tc.eye, centers, radius, tc.znear, tan, tc.aspect,
        h, w)
    if h % 8 == 0 and w % 128 == 0:       # the sizes JAX's prologue takes
        jw, jo, jord = raster_pallas.tiled_prologue(
            jc.view[:3, :3], jc.eye, jnp.asarray(_np(centers)), radius,
            jc.znear, jnp.asarray(_np(tan)), jc.aspect, h, w)
        n_tiles = (h // 8) * (w // 128)
        np.testing.assert_array_equal(_np(wins), np.asarray(jw)[:n_tiles])
        np.testing.assert_array_equal(_np(order), np.asarray(jord))
        np.testing.assert_allclose(_np(ocb), np.asarray(jo), atol=1e-6,
                                   rtol=0)
    assert rect.dtype == torch.int32 and tuple(rect.shape) == (4, len(order))
    binned = int(wins[0, 6])               # sorted spheres before the global
    assert 0 < binned < len(order)
    assert (rect[:, binned:] == torch.tensor([[0], [w - 1], [0], [h - 1]])
            ).all()
    _, dirs = TR.pixel_rays(tc, h, w)
    assert _hits_inside_rect(ocb, rect, dirs, tc.znear) > 200


def test_rect_is_conservative_on_datagen_cameras(draped):
    h, w = 48, 256
    n_worlds = 6
    cams = TD.randomized_cameras(n_worlds,
                                 torch.Generator().manual_seed(11),
                                 device="cpu")
    base = _with_strays(draped[0], 2)
    rng = np.random.default_rng(12)
    centers = torch.stack([base + torch.tensor(
        rng.normal(0, 0.3, (1, 3)).astype(np.float32))
        for _ in range(n_worlds)])
    radius = torch.full((n_worlds,), draped[1])
    tan = torch.tan(cams.fovy_rad / 2.0)
    wins, ocb, order, rect = rk.tiled_prologue_batched(
        cams.view[:, :3, :3], cams.eye, centers, radius, cams.znear, tan,
        cams.aspect, h, w)
    _, dirs = TR.pixel_rays(cams, h, w)
    pairs = 0
    for i in range(n_worlds):
        w1, o1, r1, rect1 = rk.tiled_prologue(
            cams.view[i, :3, :3], cams.eye[i], centers[i], radius[i],
            cams.znear[i], tan[i], cams.aspect[i], h, w)
        assert torch.equal(rect[i], rect1) and torch.equal(wins[i], w1)
        assert torch.equal(ocb[i], o1) and torch.equal(order[i], r1)
        pairs += _hits_inside_rect(ocb[i], rect[i], dirs[i], cams.znear[i])
    assert pairs > 500


def _random_wins(seed, n_worlds, n_tiles, n):
    """Candidate ranges of the prologue's shape: three increasing ring
    ranges (some empty) and the global range, per tile."""
    rng = np.random.default_rng(seed)
    out = np.zeros((n_worlds, n_tiles, 8), np.int32)
    for b in range(n_worlds):
        for t in range(n_tiles):
            cuts = np.sort(rng.integers(0, n, 6))
            heavy = rng.random() < 0.2
            for g in range(3):
                lo, hi = cuts[2 * g], cuts[2 * g + 1]
                if not heavy and rng.random() < 0.5:
                    hi = min(hi, lo + rng.integers(0, 9))
                out[b, t, 2 * g:2 * g + 2] = (lo, hi)
            out[b, t, 6:8] = (n - rng.integers(0, 5), n)
    out[0, 0] = 0                           # a tile with no candidate
    return torch.tensor(out)


def _item_candidates(wins8, item_start, item_tile, c, k):
    """The kernel's decode of item k: (tile, sub-tile, sorted indices)."""
    q = int(item_tile[k])
    local = k - int(item_start[q])
    sub, ck = local % rk.SUBS, local // rk.SUBS
    idx = torch.cat([torch.arange(int(wins8[q, 2 * g]),
                                  max(int(wins8[q, 2 * g]),
                                      int(wins8[q, 2 * g + 1])))
                     for g in range(4)])
    return q, sub, idx[ck * c:(ck + 1) * c]


@pytest.mark.parametrize("chunk", [1, 5, 64, rk.CHUNK])
def test_work_list_covers_each_candidate_once(chunk):
    wins = _random_wins(3, 3, 10, 400)
    item_start, item_tile, c = rk.work_list(wins, chunk)
    c = int(c)
    assert c >= chunk
    w8 = wins.reshape(-1, 8)
    nq = w8.shape[0]
    total = int(item_start[-1])
    assert item_start.dtype == torch.int32 and item_tile.dtype == torch.int32
    assert len(item_start) == nq + 1 and total <= len(item_tile)
    seen = {}
    for k in range(total):
        q, sub, idx = _item_candidates(w8, item_start, item_tile, c, k)
        assert len(idx) <= c
        seen.setdefault((q, sub), []).append(idx)
    for q in range(nq):
        want = torch.cat([torch.arange(int(w8[q, 2 * g]),
                                       max(int(w8[q, 2 * g]),
                                           int(w8[q, 2 * g + 1])))
                          for g in range(4)])
        for sub in range(rk.SUBS):
            got = torch.cat(seen[(q, sub)])
            assert torch.equal(got, want), (q, sub)
            assert len(seen[(q, sub)]) == max(1, -(-len(want) // c))


def test_work_list_chunk_grows_to_fit_the_buffer():
    """Many candidates a tile: the chunk grows past its floor so that the
    items fit SUBS · (tiles + max(tiles, _EXTRA_ITEMS))."""
    n = 3 * rk._EXTRA_ITEMS
    wins = torch.tensor([[0, n, 0, n, 0, n, n, n]] * 5, dtype=torch.int32)
    item_start, item_tile, c = rk.work_list(wins, 1)
    assert int(c) > 1 and int(item_start[-1]) <= len(item_tile)


def _emulate_kernel(wins, ocb, rect, dirs, znear, chunk):
    """The kernel's algorithm on the CPU, one world: per item, its 8×32
    pixels, each 4×8 patch culling the chunk's candidates with ``rect``,
    each pixel the first strict minimum over its patch's list; one-chunk
    tiles written directly, the rest merged by the least (t, index)."""
    h, w = dirs.shape[-2:]
    n = ocb.shape[1]
    sub_w = 128 // rk.SUBS
    item_start, item_tile, c = rk.work_list(wins, chunk)
    c = int(c)
    tx_t = rk.tile_grid(h, w)[1]
    tmin = torch.full((h, w), float("inf"))
    inst = torch.full((h, w), -1, dtype=torch.int32)
    key = {}
    for k in range(int(item_start[-1])):
        q, sub, idx = _item_candidates(wins, item_start, item_tile, c, k)
        direct = int(item_start[q + 1] - item_start[q]) == rk.SUBS
        y0, x0 = (q // tx_t) * 8, (q % tx_t) * 128 + sub * sub_w
        for pr in range(2):
            for pc in range(sub_w // 8):
                ry, rx = y0 + 4 * pr, x0 + 8 * pc
                r = rect[:, idx.long()] if n else rect[:, :0]
                keep = ((r[0] <= rx + 7) & (r[1] >= rx) & (r[2] <= ry + 3)
                        & (r[3] >= ry))
                lst = idx[keep].long()
                for py in range(ry, min(ry + 4, h)):
                    for px in range(rx, min(rx + 8, w)):
                        d = dirs[:, py, px]
                        o = ocb[:, lst]
                        b = d[0] * o[0] + d[1] * o[1] + d[2] * o[2]
                        disc = b * b - o[3]
                        t = b - torch.sqrt(torch.clamp_min(disc, 0.0))
                        ok = (disc > 0.0) & (t > znear)
                        best_t, best_i = float("inf"), -1
                        for tt, jj in zip(t[ok].tolist(), lst[ok].tolist()):
                            if tt < best_t:               # strict: the first
                                best_t, best_i = tt, jj
                        if direct:
                            tmin[py, px], inst[py, px] = best_t, best_i
                        elif best_i >= 0:
                            key[(py, px)] = min(key.get((py, px), (np.inf, n)),
                                                (best_t, best_i))
    for (py, px), (tt, jj) in key.items():
        tmin[py, px], inst[py, px] = tt, jj
    oc = torch.where(inst[None] >= 0, ocb[:3, inst.clamp_min(0).long()],
                     0.0)
    return tmin, inst, oc


@pytest.mark.parametrize("chunk", [16, rk.CHUNK])
def test_kernel_algorithm_equals_full_sweep_with_ties(draped, chunk):
    """The mirror of the kernel on a 24×136 frame (ragged tiles) of the
    draped cloth, with exact-t ties: copies of spheres placed later in
    the instance order, so they sort later in the same tile, past a run of
    spheres that pushes them into a later chunk."""
    h, w = 24, 136
    centers, radius = draped
    sel = centers[::3]
    centers = torch.cat([sel, centers[1::3], sel[:40]])     # 40 exact ties
    _, tc = _flagship_view(h, w)
    _, dirs = TR.pixel_rays(tc, h, w)
    wins, ocb, order, rect = rk.tiled_prologue(
        tc.view[:3, :3], tc.eye, centers, radius, tc.znear,
        torch.tan(tc.fovy_rad / 2.0), tc.aspect, h, w)
    ref = rk.sphere_raster_plain(ocb, dirs, tc.znear)
    got = _emulate_kernel(wins, ocb, rect, dirs, tc.znear, chunk)
    assert int((ref[1] >= 0).sum()) > 200
    first = torch.arange(len(sel[:40]))                     # tied originals
    won = set(order[ref[1][ref[1] >= 0].long()].tolist())
    assert won & set(first.tolist())
    assert not won & set(range(len(centers) - 40, len(centers)))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_rect_unbinned_spheres_span_the_frame():
    """A sphere the binning sends to the global range (too close, behind
    the camera, or too large) gets the whole frame, so the kernel never
    culls it."""
    h, w = 64, 128
    _, tc = _flagship_view(h, w)
    eye = tc.eye
    fwd = -tc.view[2, :3]
    centers = torch.stack([eye + 0.05 * fwd, eye - 3.0 * fwd,
                           eye + 1.0 * fwd, eye + 20.0 * fwd])
    wins, ocb, order, rect = rk.tiled_prologue(
        tc.view[:3, :3], eye, centers, 0.3, tc.znear,
        torch.tan(tc.fovy_rad / 2.0), tc.aspect, h, w)
    glob = int(wins[0, 6])
    assert glob == 1                                         # one binned
    assert (rect[:, glob:] == torch.tensor([[0], [w - 1], [0], [h - 1]])
            ).all()
    assert int(rect[1, 0] - rect[0, 0]) < 16


# ---------------------------------------------------------------------------
# K10–K12: the lane-split walk
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def thin_set():
    """The self-collision candidate set of a fresh 64² sheet of the
    flagship's spacing (thin CIV, block 256, slab 1024): windows of ~200
    candidates, every neighbour in contact."""
    side = 64
    c = tcfg.ClothConfig(height=side, width=side, cloth_size=30.0 * side / 256)
    s = tstate.init_cloth_state(c, device="cpu")
    rng = np.random.default_rng(5)
    pos = s.pos + torch.tensor(rng.normal(0, 0.004, tuple(s.pos.shape))
                               .astype(np.float32))
    n = side * side
    spec = tcloth.default_self_collision_grid(c, skin=2.0 * c.particle_radius)
    grid, slabs, dropped = tcloth._frozen_structs(
        pos.reshape(3, n), s.vel.reshape(3, n), spec, 256, 1024, stats=True)
    assert int(dropped) == 0
    return grid.sorted_pos, slabs, 2.0 * c.particle_radius, c.k_contact


def _lane_split_forces(pos, md, kc, slabs, n_lanes):
    """The walk's summation order: per slab (A, then B) and group, lane l
    sums the terms of window slots l, l + L, ... in double, in order; the
    butterfly adds lane l ^ m to lane l for m = L/2 .. 1; lane 0's sum is
    rounded once and added to the slab's float total; f = A + B."""
    n = pos.shape[1]
    md = torch.tensor(md, dtype=torch.float32)
    kc = torch.tensor(kc, dtype=torch.float32)
    md2 = md * md
    totals = []
    for lo, hi in gk.slab_ranges(slabs, n):
        tot = torch.zeros((3, n))
        for g in range(slabs.ng):
            width = int(torch.clamp_min(hi[:, g] - lo[:, g], 0).max())
            part = torch.zeros((n_lanes, 3, n), dtype=torch.float64)
            for m in range(-(-width // n_lanes)):
                for lane in range(n_lanes):
                    j = lo[:, g] + m * n_lanes + lane
                    valid = j < hi[:, g]
                    jj = torch.clamp(j, 0, n - 1)
                    ds = [pos[e] - pos[e][jj] for e in range(3)]
                    d2 = ds[0] * ds[0] + ds[1] * ds[1] + ds[2] * ds[2]
                    touching = valid & (d2 < md2) & (d2 > 1e-12)
                    inv = 1.0 / torch.sqrt(torch.where(touching, d2, 1.0))
                    wgt = kc * (md * inv - 1.0)
                    for e in range(3):
                        part[lane, e] += torch.where(
                            touching, wgt * ds[e], 0.0).double()
            step = n_lanes // 2
            while step >= 1:
                part = part + part[torch.arange(n_lanes) ^ step]
                step //= 2
            tot += part[0].float()
        totals.append(tot)
    return totals[0] + totals[1]


@pytest.mark.parametrize("n_lanes", [1, 2, 4, 8])
def test_lane_split_sum_equals_plain(thin_set, n_lanes):
    pos, slabs, md, kc = thin_set
    n = pos.shape[1]
    (a_lo, a_hi), _ = gk.slab_ranges(slabs, n)
    assert float(torch.clamp_min(a_hi - a_lo, 0).float().mean()) > 150
    ref = gk.contact_forces_sorted_plain(pos, md, kc, slabs)
    got = _lane_split_forces(pos, md, kc, slabs, n_lanes)
    assert float(ref.abs().max()) > 0
    assert torch.equal(got, ref)


def test_walk_geometry_follows_the_candidate_set(thin_set):
    """One lane and a CTA a block on the full set, at any size, read
    directly; on a thin set, staged, the most lanes (a power of two up to
    MAX_LANES) whose slots still fit the card's resident threads, in CTAs
    of at most CTA_THREADS threads inside one block."""
    _, slabs, _, _ = thin_set
    h100 = 132 * 2048
    assert slabs.ng == 3
    assert gk.lanes(slabs, 65536, h100) == 4        # the 256² cloth
    assert gk.lanes(slabs, 1_000_000, h100) == 1    # the 1M pile
    assert gk.lanes(slabs, 4096, h100) == gk.MAX_LANES
    n_lanes, cta, stage = gk.walk_geometry(slabs, 65536, h100)
    assert n_lanes == 4 and slabs.block % cta == 0 and stage
    assert cta * n_lanes <= gk.CTA_THREADS
    assert gk.walk_geometry(slabs, 1_000_000, h100) == (1, slabs.block,
                                                         True)
    full = slabs._replace(off=torch.zeros((1, 9, 2), dtype=torch.int32),
                          bounds=((0, 0),) * 9, block=128)
    assert gk.walk_geometry(full, 4096, h100) == (1, 128, False)
    for block in (96, 100, 7):
        n_lanes, cta, _ = gk.walk_geometry(slabs._replace(block=block),
                                           65536, h100)
        assert block % cta == 0 and cta * n_lanes <= gk.CTA_THREADS
