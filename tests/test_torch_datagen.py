"""Port parity, the batched datagen slice: the torch package's batched
cloth stepping, binning, textures, globe pre-render, ``step_and_render``,
``generate_trajectory_dataset`` and CLI against the JAX package's (CPU).
Worlds and cameras come from JAX's own ``randomized_worlds`` /
``randomized_cameras`` and are carried across with
``world_batch_from_numpy``, so both packages start from the same values.

Tolerances:

* the batched plain stepper against JAX's lane-folded kernel K5
  (``cloth_pallas.multi_step`` on a 4-D state, interpret mode): 1e-5 pos /
  1e-4 vel, the single-world contract of the plain stepper against JAX's
  K1 (``tests/test_torch_cloth.py``). JAX's K5 is within 1e-6 of its K1
  (``tests/test_cloth_pallas.py:152-155``), so the gap is torch's CPU
  rounding against XLA's, not the batching: over 25 substeps of these
  perturbed states it measures 3.8e-6 in pos and 4.2e-5 in vel (the
  velocity carries a position ulp times 1/dt). World i of the batched
  plain run equals the single-world run exactly;
* the batched prologue equals the single-world prologue exactly, world by
  world, and JAX's ``wins``/``order`` exactly and ``ocb`` to 1e-6;
* ``pack_rgb8``/``sample_bilinear_packed`` 1e-7, the mip 1e-6;
* the cached globe: the form of the ``draw_globe`` contract of
  ``tests/test_torch_render.py``: depth 1e-5; colour 1e-5 where JAX's own
  colour moves by <= 1e-6 when the eye moves two ulps, 1e-5 plus eight
  times that move elsewhere, and the uint8 cast within 1. The packed
  256² texture seen from the random datagen cameras is more sensitive
  than the single-camera case: libm ulps of ``atan2``/``asin`` move
  ``u``/``v`` by more than two ulps of the eye do (measured on this
  input: 4.2e-6 where the move is <= 1e-6, 6.5 times the move
  elsewhere);
* frames, uint8 |Δ| <= 1, the bound ``tests/test_codec.py:199-200`` holds
  JAX's own two render paths to. One kind of pixel is exempt: where JAX's
  two paths (``batch_binned`` True and False) themselves differ by more
  than 1, a particle's silhouette sits within rounding of the pixel's ray
  (the XLA path's matmul rounds ``b = oc · d`` differently), and the port
  must then match one of the two within 1.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu import render as JR
from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.core import state as jstate
from wgpu_physics_engine_tpu.ops import cloth_pallas, raster_pallas
from wgpu_physics_engine_tpu.parallel import datagen as JD
from wgpu_physics_engine_tpu.render import texture as JT
from wgpu_physics_engine_torch import render as TR
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.core import state as tstate
from wgpu_physics_engine_torch.ops import (cloth_kernel, pixel_kernel,
                                           raster_kernel)
from wgpu_physics_engine_torch.parallel import datagen as TD
from wgpu_physics_engine_torch.render import texture as TT

DT = 1.0 / 480.0
# an 8×8 cloth of large particles spawned close above the globe, so that a
# 32×128 frame (the smallest the JAX binned path takes) shows particles
CLOTH = dict(height=8, width=8, particle_radius=0.8, cloth_size=16.0,
             center=(0.0, 14.0, 0.0))
FB = (32, 128)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _camera(jc):
    """The port's Camera holding the JAX camera's exact values."""
    return TR.Camera(*(torch.tensor(np.asarray(a)) for a in jc))


def _worlds(seed, n=3, **cloth):
    """JAX's randomized worlds and cameras, and the same values as the
    port's."""
    c = jcfg.ClothConfig(**{**CLOTH, **cloth})
    jb = JD.randomized_worlds(c, n, jax.random.key(seed))
    jcams = JD.randomized_cameras(n, jax.random.key(seed + 100))
    tb = TD.world_batch_from_numpy(jax.tree.map(np.asarray, jb),
                                       device="cpu")
    return c, jb, jcams, tb, _camera(jcams)


def _packed_tex():
    jtex = JT.pack_rgb8(JT.get("mesh", max_size=256))
    return jtex, torch.tensor(np.asarray(jtex).astype(np.int32))


# ---------------------------------------------------------------------------
# Batched stepping (K5's plain version)
# ---------------------------------------------------------------------------

def _batched_state(b, h, w, seed, pins):
    c = jcfg.ClothConfig(height=h, width=w)
    base = np.asarray(jstate.init_cloth_state(c).pos)
    rng = np.random.default_rng(seed)
    pos = (base + 0.1 * rng.standard_normal((b, 3, h, w))).astype(np.float32)
    vel = (0.3 * rng.standard_normal((b, 3, h, w))).astype(np.float32)
    p1 = jstate.ClothParams.from_config(c)
    params = jstate.ClothParams(*(np.asarray(
        [np.float32(leaf) * np.float32(1.0 + 0.07 * i) for i in range(b)],
        np.float32) for leaf in p1))
    mask = pin_pos = None
    if pins:
        mask = np.zeros((b, h, w), bool)
        mask[:, 0] = True
        pin_pos = pos
    js = jstate.ClothState(pos=pos, vel=vel, pin_mask=mask, pin_pos=pin_pos)
    return js, params


@pytest.mark.parametrize("pins", [False, True])
def test_batched_plain_matches_pallas_lanes_kernel(pins):
    js, jp = _batched_state(5, 12, 20, seed=4, pins=pins)
    ref = cloth_pallas.multi_step(
        jax.tree.map(jnp.asarray, js), jax.tree.map(jnp.asarray, jp),
        jnp.float32(DT), 25, interpret=True)
    ts = tstate.state_from_numpy(js, device="cpu")
    tp = tstate.params_from_numpy(jp, device="cpu")
    got = cloth_kernel.multi_step(ts, tp, DT, 25)
    assert got.pos.shape == (5, 3, 12, 20)
    np.testing.assert_allclose(_np(got.pos), np.asarray(ref.pos), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(got.vel), np.asarray(ref.vel), atol=1e-4,
                               rtol=1e-4)
    if pins:
        np.testing.assert_array_equal(_np(got.pos)[:, :, 0], js.pos[:, :, 0])


@pytest.mark.parametrize("pins", [False, True])
def test_batched_plain_world_equals_single_world(pins):
    js, jp = _batched_state(5, 12, 20, seed=5, pins=pins)
    ts = tstate.state_from_numpy(js, device="cpu")
    tp = tstate.params_from_numpy(jp, device="cpu")
    got = cloth_kernel.multi_step_plain(ts, tp, DT, 25)
    for i in range(5):
        one = tstate.ClothState(
            pos=ts.pos[i], vel=ts.vel[i],
            pin_mask=None if ts.pin_mask is None else ts.pin_mask[i],
            pin_pos=None if ts.pin_pos is None else ts.pin_pos[i])
        ref = cloth_kernel.multi_step_plain(
            one, tstate.ClothParams(*(leaf[i] for leaf in tp)), DT, 25)
        np.testing.assert_array_equal(_np(got.pos[i]), _np(ref.pos))
        np.testing.assert_array_equal(_np(got.vel[i]), _np(ref.vel))


def test_batched_shared_params_and_packing():
    """A 4-D state with shared 0-d params broadcasts them; ``[B]`` params
    pack to one row per world, equal to each world's 0-d vector."""
    js, jp = _batched_state(3, 8, 10, seed=6, pins=False)
    ts = tstate.state_from_numpy(js, device="cpu")
    tp = tstate.params_from_numpy(jp, device="cpu")
    rows = cloth_kernel._pack_params(tp, DT)
    assert rows.shape == (3, 16)
    for i in range(3):
        one = cloth_kernel._pack_params(
            tstate.ClothParams(*(leaf[i] for leaf in tp)), DT)
        np.testing.assert_array_equal(_np(rows[i]), _np(one))
    shared = tstate.ClothParams(*(leaf[0] for leaf in tp))
    got = cloth_kernel.multi_step(ts, shared, DT, 10)
    ref = cloth_kernel.multi_step(
        ts, tstate.ClothParams(*(leaf[:1].expand(3) for leaf in tp)), DT, 10)
    np.testing.assert_array_equal(_np(got.pos), _np(ref.pos))
    with pytest.raises(ValueError):
        cloth_kernel.multi_step(ts, tstate.ClothParams(
            *(leaf[:2] for leaf in tp)), DT, 1)


def test_world_batch_from_numpy_carries_leaves():
    _, jb, _, tb, _ = _worlds(0)
    assert tb.state.pos.shape == (3, 3, 8, 8) and tb.params.k_struct.shape == (3,)
    np.testing.assert_array_equal(_np(tb.state.vel), np.asarray(jb.state.vel))
    np.testing.assert_array_equal(_np(tb.params.k_bend),
                                  np.asarray(jb.params.k_bend))


# ---------------------------------------------------------------------------
# Batched binning prologue
# ---------------------------------------------------------------------------

def test_batched_prologue_matches_per_world_and_jax():
    c, jb, jcams, tb, tcams = _worlds(1)
    h, w = FB
    centers = tb.state.pos.reshape(3, 3, -1).transpose(1, 2)
    tan = torch.tan(tcams.fovy_rad / 2.0)
    wins, ocb, order, rect = raster_kernel.tiled_prologue_batched(
        tcams.view[:, :3, :3], tcams.eye, centers, tb.params.particle_radius,
        tcams.znear, tan, tcams.aspect, h, w)
    n_tiles = (h // 8) * (w // 128)
    assert wins.shape == (3, n_tiles, 8) and ocb.shape == (3, 4, 64)
    for i in range(3):
        w1, o1, r1, _ = raster_kernel.tiled_prologue(
            tcams.view[i, :3, :3], tcams.eye[i], centers[i],
            tb.params.particle_radius[i], tcams.znear[i], tan[i],
            tcams.aspect[i], h, w)
        np.testing.assert_array_equal(_np(wins[i]), _np(w1))
        np.testing.assert_array_equal(_np(ocb[i]), _np(o1))
        np.testing.assert_array_equal(_np(order[i]), _np(r1))
        jw, jo, jr = raster_pallas.tiled_prologue(
            jcams.view[i, :3, :3], jcams.eye[i],
            jnp.asarray(_np(centers[i])), float(jb.params.particle_radius[i]),
            jcams.znear[i], jnp.asarray(_np(tan[i])), jcams.aspect[i], h, w)
        np.testing.assert_array_equal(_np(wins[i]), np.asarray(jw)[:n_tiles])
        np.testing.assert_array_equal(_np(order[i]), np.asarray(jr))
        np.testing.assert_allclose(_np(ocb[i]), np.asarray(jo), atol=1e-6,
                                   rtol=0)
    # the three per-world sweeps equal one batched sweep
    _, dirs = TR.pixel_rays(tcams, h, w)
    bt, bi, bo = raster_kernel.sphere_raster_binned(wins, ocb, rect, dirs,
                                                    tcams.znear)
    for i in range(3):
        t1, i1, o1 = raster_kernel.sphere_raster_binned(
            wins[i], ocb[i], rect[i], dirs[i], tcams.znear[i])
        np.testing.assert_array_equal(_np(bi[i]), _np(i1))
        np.testing.assert_array_equal(_np(bt[i]), _np(t1))
    assert (_np(bi) >= 0).sum() > 200


# ---------------------------------------------------------------------------
# Textures
# ---------------------------------------------------------------------------

def test_pack_rgb8_and_packed_sampler_match_jax():
    rng = np.random.default_rng(0)
    tex = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    u = rng.uniform(-1.5, 2.5, (2, 24, 40)).astype(np.float32)
    v = rng.uniform(-1.5, 2.5, (2, 24, 40)).astype(np.float32)
    tp = TT.pack_rgb8(torch.tensor(tex))
    jp = JT.pack_rgb8(jnp.asarray(tex))
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(_np(tp), np.asarray(jp).astype(np.int64))
    got = TT.sample(tp, torch.tensor(u), torch.tensor(v))
    ref = JT.sample(jp, jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-7, rtol=0)
    # the packed sampler equals the fp32 one on 8-bit-quantized texels
    q = np.round(tex * 255.0) / 255.0
    plain = TT.sample(torch.tensor(q.astype(np.float32)), torch.tensor(u),
                      torch.tensor(v))
    np.testing.assert_allclose(_np(got), _np(plain), atol=1e-6, rtol=0)


def test_texture_mip_matches_jax():
    full = TT.get("mesh")
    mip = TT.get("mesh", max_size=256)
    assert full.shape[0] > 256 and mip.shape == (256, 256, 3)
    np.testing.assert_allclose(_np(mip), np.asarray(JT.get("mesh", max_size=256)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(TT.get("planet", max_size=128)),
                               np.asarray(JT.get("planet", max_size=128)),
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Cached globe, step_and_render, the generator
# ---------------------------------------------------------------------------

@jax.jit
def _jax_globes(cams, radius, tex):
    return jax.vmap(lambda c, r: JR.draw_globe(
        JR.clear(*FB), c, r, tex, jcfg.LightConfig()).color)(cams, radius)


def test_globe_base_fbs_matches_jax():
    _, jb, jcams, tb, tcams = _worlds(2)
    jtex, ttex = _packed_tex()
    ref = JD.globe_base_fbs(jcams, jb.params, jtex, fb_size=FB)
    got = TD.globe_base_fbs(tcams, tb.params, ttex, fb_size=FB, chunk=2)
    globe = _np(got.depth) < 1.0
    assert globe.mean() > 0.05
    np.testing.assert_allclose(_np(got.depth), np.asarray(ref.depth),
                               atol=1e-5, rtol=0)
    # JAX's own colour under two-ulp moves of each world's eye
    base = np.asarray(_jax_globes(jcams, jb.params.globe_radius, jtex))
    sens = np.zeros(globe.shape)
    eye = np.asarray(jcams.eye)
    for ax in range(3):
        for way in (np.inf, -np.inf):
            e2 = eye.copy()
            e2[:, ax] = np.nextafter(np.nextafter(e2[:, ax], way), way)
            moved = np.asarray(_jax_globes(jcams._replace(eye=jnp.asarray(e2)),
                                           jb.params.globe_radius, jtex))
            sens = np.maximum(sens, np.abs(moved - base).max(-1))
    well = sens <= 1e-6
    assert well[globe].mean() >= 0.2, well[globe].mean()
    d = np.abs(_np(got.color) - np.asarray(ref.color)).max(-1)
    assert d[well].max() <= 1e-5, d[well].max()
    excess = d - (1e-5 + 8.0 * sens)
    assert (excess <= 0).all(), excess.max()
    # what the frames see of it: the uint8 cast of the datagen path
    q = lambda c: (np.clip(c, 0.0, 1.0) * 255.0 + 0.5).astype(np.int16)
    assert np.abs(q(_np(got.color)) - q(np.asarray(ref.color))).max() <= 1


def _check_frames(got, ref_binned, ref_xla):
    """uint8 |Δ| <= 1 against both JAX render paths, except where those
    two differ from each other by more than 1; there, within 1 of one."""
    got = np.asarray(got).astype(np.int16)
    a = np.asarray(ref_binned).astype(np.int16)
    b = np.asarray(ref_xla).astype(np.int16)
    jax_split = np.abs(a - b).max(-1) > 1
    assert jax_split.mean() < 1e-3, jax_split.mean()
    for ref in (a, b):
        d = np.abs(got - ref).max(-1)
        assert d[~jax_split].max() <= 1, d[~jax_split].max()
    either = np.minimum(np.abs(got - a).max(-1), np.abs(got - b).max(-1))
    assert either.max() <= 1, either.max()


@pytest.mark.parametrize("seed", [0, 1])
def test_step_and_render_matches_jax(seed):
    _, jb, jcams, tb, tcams = _worlds(seed)
    jtex, ttex = _packed_tex()
    jbase = JD.globe_base_fbs(jcams, jb.params, jtex, fb_size=FB)
    tbase = TD.globe_base_fbs(tcams, tb.params, ttex, fb_size=FB)
    refs = {}
    for binned in (True, False):
        jnew, refs[binned] = JD.step_and_render(
            jb, jnp.float32(DT), 24, jcams, jtex, fb_size=FB, base_fb=jbase,
            use_pallas=False, batch_binned=binned)
    for use_kernel in (True, False):
        tnew, img = TD.step_and_render(tb, DT, 24, tcams, ttex, fb_size=FB,
                                       base_fb=tbase, use_kernel=use_kernel)
        assert img.dtype == torch.uint8 and img.shape == (3,) + FB + (3,)
        np.testing.assert_allclose(_np(tnew.state.pos),
                                   np.asarray(jnew.state.pos), atol=1e-4,
                                   rtol=1e-4)
        _check_frames(img, refs[True], refs[False])
        red = (_np(img) == [255, 0, 0]).all(-1).sum((1, 2))
        assert (red > 50).all(), red                 # particles in every world
    # without the cached globe the globe is rendered in the call
    _, fresh = TD.step_and_render(tb, DT, 24, tcams, ttex, fb_size=FB)
    _check_frames(fresh, refs[True], refs[False])


def test_generate_matches_jax_frame_by_frame():
    """The whole slice: JAX's generator (``use_pallas=False``, randomized
    cameras, two world chunks) against the port's (``use_kernel=False``)
    started from JAX's sampled worlds and cameras, frame by frame."""
    key = jax.random.key(3)
    c = jcfg.ClothConfig(**CLOTH)
    kw = dict(n_worlds=3, n_frames=3, steps_per_frame=24, fb_size=FB,
              world_chunk=2)
    ref = list(JD.generate_trajectory_dataset(
        c, key=key, use_pallas=False, randomize_cameras=True, **kw))
    # the worlds and cameras JAX's generator drew, chunk by chunk
    jbs, jcs = [], []
    for k, size in zip(jax.random.split(key, 2), (2, 1)):
        jbs.append(JD.randomized_worlds(c, size, k))
        jcs.append(JD.randomized_cameras(size, jax.random.fold_in(k, 7)))
    jb = jax.tree.map(lambda *a: np.concatenate([np.asarray(x) for x in a]),
                      *jbs)
    jcams = jax.tree.map(lambda *a: np.concatenate([np.asarray(x) for x in a]),
                         *jcs)
    got = list(TD.generate_trajectory_dataset(
        tcfg.ClothConfig(**CLOTH), use_kernel=False,
        worlds=TD.world_batch_from_numpy(jb, device="cpu"),
        camera=_camera(jcams),
        device="cpu", **kw))
    assert [f for f, _, _ in got] == [0, 1, 2] == [f for f, _, _ in ref]
    for (_, g, gb), (_, r, rb) in zip(got, ref):
        assert g.shape == (3,) + FB + (3,) and g.dtype == np.uint8
        d = np.abs(g.astype(np.int16) - r.astype(np.int16))
        assert d.max() <= 1, d.max()
        assert (g == [255, 0, 0]).all(-1).sum() > 100
    np.testing.assert_allclose(
        np.concatenate([_np(b.state.pos) for b in got[-1][2]]),
        np.concatenate([np.asarray(b.state.pos) for b in ref[-1][2]]),
        atol=1e-4, rtol=1e-4)


def _port_gen(**kw):
    args = dict(n_worlds=3, n_frames=2, steps_per_frame=6, fb_size=FB,
                generator=torch.Generator().manual_seed(7),
                randomize_cameras=True, device="cpu")
    args.update(kw)
    return TD.generate_trajectory_dataset(tcfg.ClothConfig(**CLOTH), **args)


def test_port_generator_chunks_and_zero_frames():
    frames = list(_port_gen(n_worlds=5, n_frames=1, world_chunk=3))
    assert len(frames) == 1
    _, imgs, batches = frames[0]
    assert imgs.shape == (5,) + FB + (3,)
    assert [b.state.pos.shape[0] for b in batches] == [3, 2]
    assert list(_port_gen(n_frames=0)) == []
    with pytest.raises(ValueError):
        list(_port_gen(camera=TR.make_camera()))
    with pytest.raises(ValueError):
        list(_port_gen(n_worlds=4, worlds=batches[0]))


@pytest.mark.parametrize("codec_k", [None, 16])
def test_port_generator_equals_synchronous_loop(codec_k):
    """Each yielded frame equals a plain loop of ``step_and_render`` from
    the same draws, and the batches yielded with frame f hold frame f+1's
    state (the dispatch-before-fetch order)."""
    from wgpu_physics_engine_torch.parallel import codec

    # the generator yields its one list of batches each time; snapshot it
    frames = [(f, imgs, [b.state.pos.clone() for b in batches])
              for f, imgs, batches in _port_gen(n_frames=3, codec_k=codec_k,
                                                world_chunk=2)]
    gen = torch.Generator().manual_seed(7)
    cfg = tcfg.ClothConfig(**CLOTH)
    chunks = []
    for size in (2, 1):
        b = TD.randomized_worlds(cfg, size, gen, device="cpu")
        cams = TD.randomized_cameras(size, gen, device="cpu")
        chunks.append([b, cams])
    tex = TT.pack_rgb8(TT.get("mesh", max_size=256))
    bases = [TD.globe_base_fbs(cams, b.params, tex, fb_size=FB)
             for b, cams in chunks]
    states = []
    for f, imgs, _ in frames:
        parts = []
        for ch, base in zip(chunks, bases):
            ch[0], im = TD.step_and_render(ch[0], DT, 6, ch[1], tex,
                                           fb_size=FB, base_fb=base)
            parts.append(im if codec_k is None else codec.encode(im, k=codec_k))
        np.testing.assert_array_equal(imgs, torch.cat(parts).numpy())
        states.append([b.state.pos.clone() for b, _ in chunks])
    for f in range(2):      # frame f arrives with frame f+1's state
        for got, s in zip(frames[f][2], states[f + 1]):
            np.testing.assert_array_equal(_np(got), _np(s))
    for got, s in zip(frames[2][2], states[2]):   # the last with its own
        np.testing.assert_array_equal(_np(got), _np(s))


def test_port_generator_without_cached_globe():
    """``cache_globe=False`` renders the globe in every frame from the same
    cameras and inputs, so the frames equal the cached run's exactly."""
    cached = [imgs for _, imgs, _ in _port_gen(world_chunk=2)]
    fresh = [imgs for _, imgs, _ in _port_gen(world_chunk=2,
                                              cache_globe=False)]
    for a, b in zip(cached, fresh, strict=True):
        np.testing.assert_array_equal(a, b)


def test_port_generator_diversity():
    frames = list(_port_gen(n_worlds=4, n_frames=2))
    imgs = frames[1][1].astype(np.int16)
    assert not np.array_equal(frames[0][1], frames[1][1])  # the cloth moves
    for i in range(4):
        for j in range(i + 1, 4):
            assert np.abs(imgs[i] - imgs[j]).mean() > 1.0  # other viewpoints
    b = frames[1][2][0]
    assert len(set(_np(b.params.k_struct).tolist())) == 4
    assert float(b.state.pos[:, 1].mean(-1).mean(-1).std()) > 0.5
    # both globe and particle pixels in every world
    red = (frames[1][1] == [255, 0, 0]).all(-1).sum((1, 2))
    bg = (np.abs(frames[1][1].astype(int) - [13, 13, 20]).max(-1) <= 1).sum((1, 2))
    assert (red > 20).all() and (bg < FB[0] * FB[1] - red - 20).all()


def test_cpu_datagen_launches_no_kernel():
    def counts():
        return (cloth_kernel.LAUNCHES, cloth_kernel.LAUNCHES_BATCHED,
                raster_kernel.LAUNCHES, pixel_kernel.LAUNCHES_RAYS,
                pixel_kernel.LAUNCHES_EPILOGUE)

    before = counts()
    list(_port_gen(n_frames=1))
    assert counts() == before


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def test_cli_datagen_decode_roundtrip(tmp_path, capsys):
    from wgpu_physics_engine_torch.__main__ import main
    from wgpu_physics_engine_torch.parallel import codec

    enc, dec = str(tmp_path / "enc"), str(tmp_path / "dec")
    rc = main(["datagen", "--device", "cpu", "--grid", "8", "--worlds", "3",
               "--frames", "2", "--size", "16", "128", "--codec-k", "16",
               "--quality", "2.0", "--random-cameras", "--outdir", enc])
    assert rc == 0
    assert "datagen: 6 world-frames" in capsys.readouterr().out
    assert codec.read_meta(enc) == {"codec_version": 1, "k": 16,
                                    "quality": 2.0, "fb_size": [16, 128]}
    shard = np.load(os.path.join(enc, "frame_00001.npy"))
    assert shard.shape == (3, 2, 16, 3, 16) and shard.dtype == np.int8
    assert main(["decode", "--indir", enc, "--outdir", dec]) == 0
    out = np.load(os.path.join(dec, "frame_00001_rgb.npy"))
    np.testing.assert_array_equal(out, codec.decode(shard, quality=2.0))
    # a contradicting quality is refused; a raw run has nothing to decode
    assert main(["decode", "--indir", enc, "--outdir", dec,
                 "--quality", "1.0"]) == 1
    raw = str(tmp_path / "raw")
    assert main(["datagen", "--device", "cpu", "--grid", "8", "--worlds", "2",
                 "--frames", "1", "--size", "16", "16", "--outdir", raw]) == 0
    assert np.load(os.path.join(raw, "frame_00000.npy")).dtype == np.uint8
    assert main(["decode", "--indir", raw, "--outdir", dec]) == 0


def test_cli_datagen_on_cuda_without_cuda_fails(capsys):
    from wgpu_physics_engine_torch.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    assert main(["datagen", "--worlds", "2", "--frames", "1"]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
