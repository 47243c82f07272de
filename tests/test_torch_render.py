"""Port parity, render layer: camera, texture, shading, the globe pass and
the tile-binned sphere raster of the torch package against the JAX
package's (CPU). The JAX raster kernels run in interpret mode, as in
tests/test_render.py.

Tolerances: 1e-5 abs for the camera, rays, texture sampling and Phong;
the binning prologue's ``wins`` and ``order`` bitwise and its ``ocb`` to
1e-6; the raster's ``hit`` identical on >= 99.9% of pixels, the winner the
same on >= 99.9% of hit pixels and ``oc`` to 1e-5 wherever it is.

Two outputs are ill-conditioned, so a rounding difference in an input
grows past 1e-5 on some pixels. XLA on the CPU contracts ``b = oc · d``
and ``b² - c`` into FMAs and the port does not, so the two round them
differently. Those checks state the conditioning of each pixel and hold
1e-5 plus what it allows:

* the hit distance ``t = b - sqrt(b² - c)``: one ulp of ``b`` moves ``t``
  by up to ``ulp(b) · (1 + |b| / sqrt(b² - c))``, which grows without
  bound at a silhouette; ``tmin`` holds 1e-5 plus two such ulps on every
  pixel both sides hit (measured: at most 1.3 of them);
* the globe's colour: near a silhouette (through ``t``) and near the
  texture's poles (through ``asin``), and wherever the texture has sharp
  edges, a few ulps of the ray move the colour by more than 1e-5. The
  check moves JAX's eye by two ulps along each axis and takes the largest
  change of JAX's own colour per pixel; where that stays under 3e-6 the
  port holds 1e-5, elsewhere 1e-5 plus four times that change (measured:
  at most 3.7 times).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu import render as JR
from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.ops import raster_pallas
from wgpu_physics_engine_tpu.render import shading as jshading
from wgpu_physics_engine_tpu.render import texture as JT
from wgpu_physics_engine_torch import render as TR
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.ops import raster_kernel
from wgpu_physics_engine_torch.render import shading as tshading
from wgpu_physics_engine_torch.render import texture as TT


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, atol=1e-5):
    np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=0)


CAMERAS = [dict(), dict(radius=30.0, theta=0.7, phi=0.4),
           dict(radius=55.0, theta=-2.0, phi=-0.9, target=(1.0, 2.0, -3.0))]


@pytest.mark.parametrize("kw", CAMERAS)
def test_make_camera_and_pixel_rays_match(kw):
    jc = JR.make_camera(jcfg.CameraConfig(), aspect=1.5, **kw)
    tc = TR.make_camera(tcfg.CameraConfig(), aspect=1.5, **kw)
    for f in jc._fields:
        _close(getattr(tc, f), getattr(jc, f))
    for h, w in [(16, 256), (24, 40)]:
        je, jd = JR.pixel_rays(jc, h, w)
        te, td = TR.pixel_rays(tc, h, w)
        _close(te, je)
        _close(td, jd)


def test_textures_match():
    for name in ("mesh", "planet", "red"):
        np.testing.assert_array_equal(_np(TT.get(name)), _np(JT.get(name)))
    _close(TT.checkerboard(size=64), JT.checkerboard(size=64))
    _close(TT.earth_gradient(64), JT.earth_gradient(64))


def test_sample_bilinear_matches():
    rng = np.random.default_rng(0)
    tex = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    u = rng.uniform(-1.5, 2.5, (24, 40)).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, (24, 40)).astype(np.float32)
    got = TT.sample_bilinear(torch.tensor(tex), torch.tensor(u), torch.tensor(v))
    ref = JT.sample_bilinear(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v))
    _close(got, ref)


@pytest.mark.parametrize("spec", [True, False])
def test_phong_matches(spec):
    rng = np.random.default_rng(1)
    pos = rng.uniform(-20, 20, (3, 24, 40)).astype(np.float32)
    pos[2] -= 30.0
    nrm = rng.normal(size=(3, 24, 40)).astype(np.float32)
    alb = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    lp = np.asarray([5.0, 12.0, -3.0], np.float32)
    light = dict(shininess=20.0, ks=1.5, compute_specular=spec)
    got = tshading.phong(torch.tensor(pos), torch.tensor(nrm), torch.tensor(alb),
                         torch.tensor(lp), tcfg.LightConfig(**light))
    ref = jshading.phong(jnp.asarray(pos), jnp.asarray(nrm), jnp.asarray(alb),
                         jnp.asarray(lp), jcfg.LightConfig(**light))
    _close(got, ref)


def _same_camera(jc):
    """The port's Camera holding the JAX camera's exact values."""
    return TR.Camera(*(torch.tensor(np.asarray(a)) for a in jc))


def _eye_sensitivity(jc, h, w, tex):
    """Per pixel, the largest change of JAX's globe colour when the eye
    moves by two ulps along any axis, either way."""
    def color(cam):
        return np.asarray(JR.draw_globe(JR.clear(h, w), cam, 10.0, tex,
                                        jcfg.LightConfig()).color)
    ref = color(jc)
    sens = np.zeros((h, w))
    eye = np.asarray(jc.eye)
    for ax in range(3):
        for way in (np.inf, -np.inf):
            e2 = eye.copy()
            e2[ax] = np.nextafter(np.nextafter(e2[ax], way), way)
            moved = color(jc._replace(eye=jnp.asarray(e2)))
            sens = np.maximum(sens, np.abs(moved - ref).max(-1))
    return sens


# texture, and the least share of globe pixels whose colour is stable to
# 3e-6 under the eye's two-ulp moves (measured: 0.33-0.44 with the grid
# texture's sharp lines, where a 1-ulp move of u shifts the sample by up to
# ~2e-5; 0.93 with the smooth gradient)
GLOBE_TEXTURES = [("mesh", 0.3), ("gradient", 0.85)]


@pytest.mark.parametrize("hw", [(32, 256), (24, 40)])
@pytest.mark.parametrize("tex_name,well_share", GLOBE_TEXTURES)
def test_draw_globe_matches(hw, tex_name, well_share):
    h, w = hw
    tex = np.asarray(JT.get("mesh") if tex_name == "mesh"
                     else JT.earth_gradient(256))
    jc = JR.make_camera(jcfg.CameraConfig(radius=30.0, phi=0.3), aspect=w / h)
    ref = JR.draw_globe(JR.clear(h, w), jc, 10.0, jnp.asarray(tex),
                        jcfg.LightConfig())
    got = TR.draw_globe(TR.clear(h, w), _same_camera(jc), 10.0,
                        torch.tensor(tex), tcfg.LightConfig())
    globe = _np(got.depth) < 1.0
    assert globe.sum() > 0.05 * h * w                  # the globe is there
    _close(got.depth, ref.depth)
    sens = _eye_sensitivity(jc, h, w, jnp.asarray(tex))
    well = sens <= 3e-6
    assert well[globe].mean() >= well_share, well[globe].mean()
    d = np.abs(_np(got.color) - _np(ref.color)).max(-1)
    assert d[well].max() <= 1e-5, d[well].max()
    excess = d - (1e-5 + 4.0 * sens)
    assert (excess <= 0).all(), (excess.max(), np.argwhere(excess > 0)[:5])


# ---------------------------------------------------------------------------
# Tile-binned sphere raster
# ---------------------------------------------------------------------------

def _scene_centers(seed=0):
    """A 12×12 sheet of spheres facing the camera, jittered, plus random
    spheres and the three global-range cases of tests/test_render.py
    (closer than znear + r, behind the camera, projecting too large)."""
    rng = np.random.default_rng(seed)
    g = np.linspace(-4.0, 4.0, 12, dtype=np.float32)
    sheet = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    sheet = np.concatenate([sheet, np.zeros((144, 1), np.float32)], 1)
    sheet += rng.normal(0, 0.05, sheet.shape).astype(np.float32)
    eye = np.asarray([0.0, 0.0, 40.0], np.float32)
    fwd = np.asarray([0.0, 0.0, -1.0], np.float32)
    return np.concatenate([
        sheet, rng.uniform(-8, 8, (120, 3)),
        [eye + fwd * 0.2, eye - fwd * 5.0, eye + fwd * 1.5],
    ]).astype(np.float32)


def _cams(h, w, aspect=1.0):
    jc = JR.make_camera(jcfg.CameraConfig(), aspect=aspect)
    tc = TR.make_camera(tcfg.CameraConfig(), aspect=aspect)
    return jc, tc


def _prologues(jc, tc, centers, radius, h, w):
    tan = np.float32(np.tan(np.float32(np.pi / 8)))
    jargs = (jc.view[:3, :3], jc.eye, jnp.asarray(centers), radius, jc.znear,
             jnp.float32(tan), jc.aspect)
    targs = (tc.view[:3, :3], tc.eye, torch.tensor(centers), radius, tc.znear,
             torch.tensor(tan), tc.aspect)
    return jargs, targs


@pytest.mark.parametrize("hw", [(16, 256), (32, 128)])
def test_tiled_prologue_matches(hw):
    h, w = hw
    centers = _scene_centers()
    jc, _ = _cams(h, w)
    tc = _same_camera(jc)      # so that only the prologue is compared
    jargs, targs = _prologues(jc, tc, centers, 0.4, h, w)
    jw, jo, jord = raster_pallas.tiled_prologue(*jargs, h, w)
    tw_, to, tord, _ = raster_kernel.tiled_prologue(*targs, h, w)
    n_tiles = (h // 8) * (w // 128)
    np.testing.assert_array_equal(_np(tw_), np.asarray(jw)[:n_tiles])
    assert not np.asarray(jw)[n_tiles:].any()        # JAX's row padding
    np.testing.assert_array_equal(_np(tord), np.asarray(jord))
    _close(to, jo, atol=1e-6)
    glob = _np(tw_)[0, 6:8]
    assert glob[1] - glob[0] >= 3          # the three global-range cases


def _t_ulp(ocb, inst, dirs):
    """Per pixel, how far ``t = b - sqrt(b² - c)`` moves when ``b`` moves
    by one ulp (and ``b² - c`` with it), in float64 from the winner's entry
    of the sorted table: ``|b| 2^-23 (1 + |b| / sqrt(b² - c))``."""
    o = _np(ocb).astype(np.float64)[:, np.clip(_np(inst), 0, None)]
    d = _np(dirs).astype(np.float64)
    b = (d * o[:3]).sum(0)
    disc = np.maximum(b * b - o[3], 1e-30)
    return np.abs(b) * 2.0 ** -23 * (1.0 + np.abs(b) / np.sqrt(disc))


def _check_tmin(got, ref, both, ulp):
    """``tmin`` within 1e-5 plus two ulps of ``b`` carried through the
    condition number, on every pixel both sides hit."""
    excess = np.abs(_np(got)[both] - _np(ref)[both]) - (1e-5 + 2.0 * ulp[both])
    assert (excess <= 0).all(), excess.max()


def _winner_ids(order, inst):
    inst = _np(inst)
    return np.where(inst >= 0, _np(order)[np.clip(inst, 0, None)], -1)


@pytest.mark.parametrize("hw", [(16, 256), (32, 256)])
def test_raster_plain_matches_pallas_tiled(hw):
    h, w = hw
    centers = _scene_centers(1)
    jc, _ = _cams(h, w)
    tc = _same_camera(jc)
    je, jd = JR.pixel_rays(jc, h, w)
    te, td = tc.eye, torch.tensor(np.asarray(jd))
    jargs, targs = _prologues(jc, tc, centers, 0.4, h, w)
    rt, rhit, roc = raster_pallas.sphere_raster_tiled(
        jargs[0], je, jd, *jargs[2:], interpret=True, return_oc=True)
    _, rinst = raster_pallas.sphere_raster_tiled(
        jargs[0], je, jd, *jargs[2:], interpret=True)
    wins, ocb, order, rect = raster_kernel.tiled_prologue(*targs, h, w)
    gt, ginst, goc = raster_kernel.sphere_raster_binned(wins, ocb, rect, td,
                                                        tc.znear)
    ghit = _np(ginst) >= 0
    assert ghit.sum() > 200                           # the scene hits
    assert (ghit == np.asarray(rhit)).mean() >= 0.999
    same = (_winner_ids(order, ginst) == np.asarray(rinst)) & ghit
    assert same.sum() >= 0.999 * ghit.sum()
    _close(_np(goc)[:, same], np.asarray(roc)[:, same])
    _check_tmin(gt, rt, ghit & np.asarray(rhit), _t_ulp(ocb, ginst, td))
    assert (_np(goc)[:, ~ghit] == 0).all() and np.isinf(_np(gt)[~ghit]).all()
    # the public entry gives the same
    t2, hit2, oc2 = raster_kernel.sphere_raster_tiled(
        tc.view[:3, :3], te, td, torch.tensor(centers), 0.4, tc.znear,
        torch.tan(tc.fovy_rad / 2.0), tc.aspect)
    np.testing.assert_array_equal(_np(hit2), ghit)


def _sweep_tiles(wins, ocb, dirs, znear):
    """The CUDA kernel's algorithm in torch: per (8, 128) tile, only the
    candidates of its four ranges from ``wins``, in range order."""
    h, w = dirs.shape[-2:]
    ty_t, tx_t = raster_kernel.tile_grid(h, w)
    tmin = torch.full((h, w), float("inf"))
    inst = torch.full((h, w), -1, dtype=torch.int32)
    oc = torch.zeros((3, h, w))
    for t in range(ty_t * tx_t):
        r0, c0 = (t // tx_t) * 8, (t % tx_t) * 128
        rs, cs = slice(r0, r0 + 8), slice(c0, c0 + 128)
        idx = torch.cat([torch.arange(int(wins[t, 2 * g]), int(wins[t, 2 * g + 1]))
                         for g in range(4)]).long()
        tm, ins, o = raster_kernel.sphere_raster_plain(
            ocb[:, idx], dirs[:, rs, cs].contiguous(), znear)
        tmin[rs, cs] = tm
        inst[rs, cs] = torch.where(ins >= 0, idx[ins.clamp_min(0).long()].int(),
                                   -1)
        oc[:, rs, cs] = o
    return tmin, inst, oc


@pytest.mark.parametrize("hw,radius", [((24, 40), 0.4), ((21, 300), 0.3),
                                       ((64, 136), 0.15)])
def test_tile_sweep_equals_brute_force_on_ragged_sizes(hw, radius):
    """The binning is conservative at any framebuffer size: sweeping only
    each tile's ranges (what the CUDA kernel does, with tiles ceil-divided)
    gives the brute-force sweep's output bit for bit, ties included."""
    h, w = hw
    centers = _scene_centers(2)
    _, tc = _cams(h, w, aspect=w / h)
    _, td = TR.pixel_rays(tc, h, w)
    wins, ocb, _, _ = raster_kernel.tiled_prologue(
        tc.view[:3, :3], tc.eye, torch.tensor(centers), radius, tc.znear,
        torch.tan(tc.fovy_rad / 2.0), tc.aspect, h, w)
    assert tuple(wins.shape) == (raster_kernel.tile_grid(h, w)[0]
                                 * raster_kernel.tile_grid(h, w)[1], 8)
    bt, bi, bo = raster_kernel.sphere_raster_plain(ocb, td, tc.znear)
    st, si, so = _sweep_tiles(wins, ocb, td, tc.znear)
    assert (_np(bi) >= 0).sum() > 20
    np.testing.assert_array_equal(_np(si), _np(bi))
    np.testing.assert_array_equal(_np(st), _np(bt))
    np.testing.assert_array_equal(_np(so), _np(bo))


def test_raster_plain_matches_untiled_kernel_on_ragged_size():
    """At a size the JAX tiled kernel refuses (24 × 40), the port's raster
    agrees with the JAX untiled kernel K4 on every winner."""
    h, w = 24, 40
    centers = _scene_centers(3)
    jc, _ = _cams(h, w, aspect=w / h)
    tc = _same_camera(jc)
    je, jd = JR.pixel_rays(jc, h, w)
    td = torch.tensor(np.asarray(jd))
    rt, rinst = raster_pallas.sphere_raster(je, jd, jnp.asarray(centers), 0.4,
                                            jc.znear, interpret=True)
    wins, ocb, order, rect = raster_kernel.tiled_prologue(
        tc.view[:3, :3], tc.eye, torch.tensor(centers), 0.4, tc.znear,
        torch.tan(tc.fovy_rad / 2.0), tc.aspect, h, w)
    gt, ginst, _ = raster_kernel.sphere_raster_binned(wins, ocb, rect, td,
                                                      tc.znear)
    ids = _winner_ids(order, ginst)
    hit = ids >= 0
    assert hit.sum() > 20
    assert (hit == (np.asarray(rinst) >= 0)).mean() >= 0.999
    assert ((ids == np.asarray(rinst)) & hit).sum() >= 0.999 * hit.sum()
    _check_tmin(gt, rt, hit & (np.asarray(rinst) >= 0), _t_ulp(ocb, ginst, td))


def test_raster_plain_matches_pallas_chunked_table():
    """Beyond 16,384 instances JAX cuts the sorted table into chunks (K3,
    ``_tiled_kernel_chunked``); the port's one sweep over the whole table
    gives the same winners. 20,000 spheres: 500 close to the eye, which
    project too large for the tile ring and go to the global range at the
    end of the sorted table, and 19,500 farther ones in the ring ranges, so
    every chunk of the table holds candidates. Winners are compared by
    their eye-relative centre ``oc`` (``return_oc`` gives no ids)."""
    h, w = 16, 256
    rng = np.random.default_rng(5)

    def frustum_box(n, z0, z1):
        z = rng.uniform(z0, z1, n)
        half = 0.4 * (40.0 - z)                # the eye sits at z = 40
        return np.stack([rng.uniform(-1, 1, n) * half,
                         rng.uniform(-1, 1, n) * half, z], 1)

    centers = np.concatenate([frustum_box(19500, -20.0, 15.0),
                              frustum_box(500, 30.0, 34.0)]).astype(np.float32)
    rng.shuffle(centers)
    assert len(centers) > raster_pallas.MAX_INSTANCES
    jc, _ = _cams(h, w)
    tc = _same_camera(jc)
    je, jd = JR.pixel_rays(jc, h, w)
    td = torch.tensor(np.asarray(jd))
    jargs, targs = _prologues(jc, tc, centers, 0.4, h, w)
    rt, rhit, roc = (np.asarray(a) for a in raster_pallas.sphere_raster_tiled(
        jargs[0], je, jd, *jargs[2:], interpret=True, return_oc=True))
    wins, ocb, _, rect = raster_kernel.tiled_prologue(*targs, h, w)
    glob = _np(wins)[0, 6:8]
    assert 0 < glob[0] < raster_pallas.MAX_INSTANCES < glob[1]   # both kinds
    gt, ginst, goc = raster_kernel.sphere_raster_binned(wins, ocb, rect, td,
                                                        tc.znear)
    ghit = _np(ginst) >= 0
    assert ghit.sum() > 0.9 * h * w
    assert (ghit == rhit).mean() >= 0.999
    same = ghit & rhit & (np.abs(_np(goc) - roc).max(0) <= 1e-5)
    assert same.sum() >= 0.999 * ghit.sum()
    _check_tmin(gt, rt, ghit & rhit, _t_ulp(ocb, ginst, td))


# ---------------------------------------------------------------------------
# The datagens' uint8 entry (draw_instanced_spheres_rgb8)
# ---------------------------------------------------------------------------

def _shell_centers(rng, n):
    """``n`` sphere centres on a shell 0.4-3 outside the globe (radius 10),
    all around it: from any orbit camera some lie in front of the globe
    and some behind it."""
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (d * rng.uniform(10.4, 13.0, (n, 1))).astype(np.float32)


@pytest.mark.parametrize("flat", [(1.0, 0.0, 0.0), (0.86, 0.65, 0.35)])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("hw", [(256, 256), (37, 61)])
def test_rgb8_entry_equals_plain_route_and_cast(batched, hw, flat):
    """On the CPU the uint8 entry is ``draw_instanced_spheres`` and the
    datagens' cast, bit for bit, on one world (the tiled raster at 256²,
    the untiled one at 37×61) and on a batch, in the cloth datagen's red
    and the granular datagen's sand (three channels apart, none 0 or 1),
    with pixels that miss, that hit in front of the globe and that hit
    behind it; it launches no kernel."""
    from wgpu_physics_engine_torch.ops import pixel_kernel
    from wgpu_physics_engine_torch.render import raster

    h, w = hw
    rng = np.random.default_rng(11)
    if batched:
        cam = TR.make_camera(tcfg.CameraConfig(), aspect=w / h,
                             radius=torch.tensor([30.0, 45.0]),
                             theta=torch.tensor([0.3, 2.5]),
                             phi=torch.tensor([0.3, 0.9]))
        centers = torch.tensor(np.stack([_shell_centers(rng, 300)
                                         for _ in range(2)]))
    else:
        cam = TR.make_camera(tcfg.CameraConfig(radius=30.0, phi=0.3),
                             aspect=w / h)
        centers = torch.tensor(_shell_centers(rng, 300))
    n_worlds = 2 if batched else None
    base = TR.draw_globe(TR.clear(h, w, n_worlds=n_worlds), cam, 10.0,
                         TT.get("mesh", max_size=64), tcfg.LightConfig())
    counts = (pixel_kernel.LAUNCHES_RAYS, pixel_kernel.LAUNCHES_EPILOGUE,
              raster_kernel.LAUNCHES, raster_kernel.LAUNCHES_UNTILED)
    got = TR.draw_instanced_spheres_rgb8(base, cam, centers, 0.6,
                                         flat_color=flat)
    fb = TR.draw_instanced_spheres(base, cam, centers, 0.6, flat_color=flat)
    ref = (torch.clamp(fb.color, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    assert (pixel_kernel.LAUNCHES_RAYS, pixel_kernel.LAUNCHES_EPILOGUE,
            raster_kernel.LAUNCHES, raster_kernel.LAUNCHES_UNTILED) == counts
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    assert torch.equal(got, ref)
    # every kind of pixel occurs: a miss, a hit that wins, a hit the globe
    # hides
    eye, dirs = TR.pixel_rays(cam, h, w)
    hit = raster._nearest_hits(cam, eye, dirs, centers, 0.6)[1] >= 0
    flat8 = (torch.tensor(flat) * 255.0 + 0.5).to(torch.uint8)
    won = (got == flat8).all(-1)
    base8 = (torch.clamp(base.color, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    hidden = hit & ~won & (got == base8).all(-1)
    assert int((~hit).sum()) > 50
    assert int((hit & won).sum()) > 20
    assert int(hidden.sum()) > 20
