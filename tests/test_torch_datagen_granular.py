"""Port parity, granular datagen: the torch package's
``parallel/datagen_granular.py`` against the JAX package's (CPU).

The three tests of ``tests/test_datagen_granular.py`` are mirrored on the
port (``CFG`` = 200 particles): chunking with the remainder chunk, the
per-world materials, the codec path. Against JAX, from one batch carried
across with ``granular_world_batch_from_numpy`` and JAX's own cameras:

* ``granular_step_and_render`` within one rebuild block (4 substeps,
  ``rebuild_every`` = 4): the state at the contact contract (pos 1e-5,
  vel 1e-4; ROADMAP "Semantics"; JAX's default CPU route is ``xla``, the
  port's the kernel route's plain version), the uint8 frames at
  ``tests/test_torch_datagen.py``'s bound, |Δ| <= 1;
* ``box_base_fbs``: the colour within 1e-4 on 99.9% of pixels and the
  depth of line pixels both draw within 1e-5 relative
  (``tests/test_torch_granular.py``'s ``draw_lines`` contract), and each
  world equal to the port's single-camera ``draw_lines`` bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from wgpu_physics_engine_tpu.models import granular as JG
from wgpu_physics_engine_tpu.parallel import datagen as JD
from wgpu_physics_engine_tpu.parallel import datagen_granular as JDG
from wgpu_physics_engine_torch import render as TR
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.models import granular
from wgpu_physics_engine_torch.parallel import codec
from wgpu_physics_engine_torch.parallel import datagen_granular as dgg

KW = dict(num_particles=200, bounds=1.0, radius=0.05, rebuild_every=4,
          pallas_block=128, pallas_slab=256, grid_capacity=16)
CFG = granular.GranularConfig(**KW)
DT = 1.0 / 240.0


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _carried(seed, n=3):
    """JAX's randomized worlds and cameras, and the same values as the
    port's."""
    jc = JG.GranularConfig(**KW)
    jb = JDG.randomized_granular_worlds(jc, n, jax.random.key(seed))
    jcams = JD.randomized_cameras(n, jax.random.key(seed + 1),
                                  radius_range=(2.2, 4.0))
    tb = dgg.granular_world_batch_from_numpy(jax.tree.map(np.asarray, jb),
                                             device="cpu")
    tc = TR.Camera(*(torch.tensor(np.asarray(a)) for a in jcams))
    return jc, jb, jcams, tb, tc


def test_dataset_shapes_and_remainder_chunk():
    """3 worlds with chunk 2 must yield ALL 3 worlds (remainder chunk),
    uint8 images with sand spheres and box lines actually rendered."""
    frames = list(dgg.generate_granular_dataset(
        CFG, n_worlds=3, n_frames=2, steps_per_frame=2, generator=_gen(0),
        fb_size=(64, 64), world_chunk=2, device="cpu"))
    assert [f for f, _, _ in frames] == [0, 1]
    for _, imgs, batches in frames:
        assert imgs.shape == (3, 64, 64, 3) and imgs.dtype == np.uint8
    assert [b.state.pos.shape[0] for b in batches] == [2, 1]
    img = frames[-1][1][0].astype(np.float32) / 255.0
    warm = (img[..., 0] > 0.5) & (img[..., 0] > img[..., 2] + 0.2)
    blue = (img[..., 2] > 0.5) & (img[..., 0] < 0.3)
    assert warm.sum() > 20 and blue.sum() > 10


def test_per_world_materials_change_physics():
    """Same initial state, different gravity/stiffness per world ->
    different trajectories; world 0 is the production physics for its
    materials, bit for bit."""
    base = granular.init_state(CFG, _gen(1), device="cpu")
    b = 3
    batch = dgg.GranularWorldBatch(
        state=base._replace(pos=torch.stack([base.pos] * b),
                            vel=torch.stack([base.vel] * b)),
        k_contact=CFG.k_contact * torch.tensor([1.0, 1.0, 2.0]),
        gravity=CFG.gravity * torch.tensor([1.0, 0.5, 1.0]),
        restitution=torch.full((b,), CFG.restitution))
    cam = TR.make_camera(tcfg.CameraConfig(radius=3.2 * CFG.bounds),
                         aspect=1.0)
    out, _ = dgg.granular_step_and_render(batch, CFG, DT, 8, cam,
                                          fb_size=(64, 64))
    p = out.state.pos
    assert not torch.equal(p[0], p[1])          # gravity differs
    assert not torch.equal(p[0], p[2])          # stiffness differs
    ref = granular.multi_step(base, CFG, DT, 8)
    assert torch.equal(p[0], ref.pos) and torch.equal(out.state.vel[0],
                                                      ref.vel)


def test_codec_path_shapes():
    frames = list(dgg.generate_granular_dataset(
        CFG, n_worlds=2, n_frames=1, steps_per_frame=1, generator=_gen(2),
        fb_size=(64, 64), codec_k=8, randomize_cameras=True, device="cpu"))
    _, enc, _ = frames[0]
    assert enc.shape == (2, 8, 8, 3, 8) and enc.dtype == np.int8
    dec = codec.decode(enc)
    assert dec.shape == (2, 64, 64, 3)


def test_step_and_render_matches_jax_within_a_block():
    jc, jb, jcams, tb, tc = _carried(3)
    jout, jimg = JDG.granular_step_and_render(jb, jc, jnp.float32(DT), 4,
                                              jcams, fb_size=(64, 64))
    tout, timg = dgg.granular_step_and_render(tb, CFG, DT, 4, tc,
                                              fb_size=(64, 64))
    np.testing.assert_allclose(tout.state.pos.numpy(),
                               np.asarray(jout.state.pos), atol=1e-5)
    np.testing.assert_allclose(tout.state.vel.numpy(),
                               np.asarray(jout.state.vel), atol=1e-4)
    for k in ("k_contact", "gravity", "restitution"):
        assert np.array_equal(getattr(tout, k).numpy(),
                              np.asarray(getattr(jout, k)))
    assert timg.dtype == torch.uint8 and timg.shape == (3, 64, 64, 3)
    d = np.abs(timg.numpy().astype(int) - np.asarray(jimg).astype(int))
    assert d.max() <= 1, d.max()
    sand = (np.abs(timg.numpy().astype(int) - [219, 166, 89]).max(-1) <= 1)
    assert sand.sum(axis=(1, 2)).min() > 20


def test_box_base_fbs_matches_jax_and_per_camera(monkeypatch):
    _, _, jcams, _, tc = _carried(5, n=4)
    ref = JDG.box_base_fbs(jcams, 1.0, (48, 64))
    monkeypatch.setattr(dgg, "BOX_CHUNK", 3)     # a full pass and a remainder
    got = dgg.box_base_fbs(tc, 1.0, (48, 64))
    blue = (got.color.numpy() == [0.0, 0.0, 1.0]).all(-1)
    assert blue.sum(axis=(1, 2)).min() > 50
    d = np.abs(got.color.numpy() - np.asarray(ref.color)).max(-1)
    assert (d <= 1e-4).mean() >= 0.999
    both = blue & (np.asarray(ref.color) == [0.0, 0.0, 1.0]).all(-1)
    np.testing.assert_allclose(got.depth.numpy()[both],
                               np.asarray(ref.depth)[both], rtol=1e-5)
    segs = TR.geometry.wireframe_box(1.0).reshape(-1, 2, 3)
    for i in range(4):
        one = TR.draw_lines(TR.clear(48, 64), TR.Camera(*(a[i] for a in tc)),
                            segs)
        assert torch.equal(one.color, got.color[i])
        assert torch.equal(one.depth, got.depth[i])


def test_cli_granular_datagen_decode_roundtrip(tmp_path, capsys):
    from wgpu_physics_engine_torch.__main__ import main

    out, rgb = str(tmp_path / "dg"), str(tmp_path / "rgb")
    assert main(["datagen", "--family", "granular", "--device", "cpu",
                 "--worlds", "3", "--frames", "2", "--particles", "300",
                 "--size", "32", "32", "--codec-k", "8", "--random-cameras",
                 "--outdir", out]) == 0
    said = capsys.readouterr().out
    assert "shard writer" in said
    enc = np.load(os.path.join(out, "frame_00001.npy"))
    assert enc.shape == (3, 4, 4, 3, 8) and enc.dtype == np.int8
    assert codec.read_meta(out)["k"] == 8
    assert main(["decode", "--indir", out, "--outdir", rgb]) == 0
    dec = np.load(os.path.join(rgb, "frame_00001_rgb.npy"))
    assert dec.shape == (3, 32, 32, 3) and dec.dtype == np.uint8
