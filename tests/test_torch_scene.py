"""Port parity, the whole slice: the torch ``ClothScene`` (step + render) on
the CPU against the JAX ``ClothScene(use_pallas=False)``.

The scene is cut to a 16×16 cloth of larger particles spawned close above
the globe, with a camera aimed at it, so that 0.25 s of simulation renders
both globe and particle pixels even at 32×256 and at the ragged 24×40.
Tolerances: positions 1e-4 (test_cloth_vs_oracle.py:74-102), images 1e-4
abs on >= 99.9% of pixels.
"""

import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.models import scenes as jscenes
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.models import scenes as tscenes
from wgpu_physics_engine_torch.ops import cloth_kernel, raster_kernel

CLOTH = dict(height=16, width=16, center=(0.0, 14.0, 0.0), cloth_size=12.0,
             particle_radius=0.5)
CAMERA = dict(target=(0.0, 12.0, 0.0), radius=25.0, phi=0.6)
BG = np.asarray([0.05, 0.05, 0.08], np.float32)
RED = np.asarray([1.0, 0.0, 0.0], np.float32)


def _scenes(use_kernel=True):
    j = jscenes.ClothScene(jcfg.ClothConfig(**CLOTH),
                           camera_cfg=jcfg.CameraConfig(**CAMERA),
                           use_pallas=False)
    t = tscenes.ClothScene(tcfg.ClothConfig(**CLOTH),
                           camera_cfg=tcfg.CameraConfig(**CAMERA),
                           use_kernel=use_kernel, device="cpu")
    return j, t


def _image_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    d = np.abs(got - ref).max(-1)
    assert (d <= 1e-4).mean() >= 0.999, (d > 1e-4).mean()


@pytest.fixture(scope="module")
def simulated():
    j, t = _scenes()
    j.simulate(0.25)
    t.simulate(0.25)
    return j, t


def test_slice_simulate_matches(simulated):
    j, t = simulated
    assert t.state.pos.device.type == "cpu"
    np.testing.assert_allclose(t.state.pos.numpy(), np.asarray(j.state.pos),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t.state.vel.numpy(), np.asarray(j.state.vel),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("hw", [(32, 256), (24, 40)])
def test_slice_render_matches(simulated, hw):
    j, t = simulated
    h, w = hw
    j.resize(w, h)
    t.resize(w, h)
    ref = j.render(h, w)
    got = t.render(h, w)
    _image_close(got, ref)
    red = (got == RED).all(-1).sum()
    bg = (np.abs(got - BG).max(-1) < 1e-6).sum()
    assert red > 50                         # cloth particles are in view
    assert h * w - red - bg > 50            # and so is the globe


def test_update_and_stencil_stepper_match():
    """``update()`` (the frame_substeps schedule) through both steppers:
    the fused-substep path and the stencil path (``use_kernel=False``)."""
    j, t = _scenes()
    _, s = _scenes(use_kernel=False)
    for dt in (1 / 60, 1 / 30, 1 / 144):
        j.update(dt)
        t.update(dt)
        s.update(dt)
    for scene in (t, s):
        np.testing.assert_allclose(scene.state.pos.numpy(),
                                   np.asarray(j.state.pos), atol=1e-4,
                                   rtol=1e-4)


def test_sliders_and_pins_match():
    j, t = _scenes()
    for scene in (j, t):
        scene.set_gravity(-4.0)
        scene.set_speed_damp(0.8)
        mask = np.zeros((16, 16), bool)
        mask[0] = True
        scene.pin(mask)
        scene.simulate(0.1)
    np.testing.assert_allclose(t.state.pos.numpy(), np.asarray(j.state.pos),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(t.state.pos[:, 0].numpy(),
                                  t.state.pin_pos[:, 0].numpy())
    for scene in (j, t):
        scene.set_particle_radius(0.3)        # resets the cloth
    np.testing.assert_array_equal(t.state.pos.numpy(), np.asarray(j.state.pos))
    assert float(t.params.particle_radius) == pytest.approx(0.3)
    assert t.spring_count == j.spring_count and t.instance_count == 256


def test_camera_and_light_controls_match():
    """Orbit, zoom and the light panel change the frame the same way."""
    j, t = _scenes()
    for scene in (j, t):
        scene.resize(40, 24)
        scene.orbit(d_theta=0.4, d_phi=0.3, d_radius=-2.0)
        scene.set_zoom(22.0)
        scene.set_light(position=(5.0, 15.0, 5.0), ks=1.0, shininess=40.0,
                        compute_specular=False)
    _image_close(t.render(24, 40), j.render(24, 40))


def test_cpu_scene_launches_no_kernel(simulated):
    _, t = simulated
    t.render(16, 128)
    assert cloth_kernel.LAUNCHES == 0 and raster_kernel.LAUNCHES == 0


def test_cli_gif_on_cpu(tmp_path, capsys):
    """The CLI's ``--gif`` path: the ``update``/``render`` frame loop.
    (PIL folds identical consecutive frames, so the count is read from the
    CLI's report, not from the file.)"""
    from PIL import Image

    from wgpu_physics_engine_torch.__main__ import main

    out = tmp_path / "cloth.gif"
    rc = main(["cloth", "--grid", "8", "--size", "16", "64", "--seconds",
               "0.2", "--fps", "10", "--gif", str(out), "--device", "cpu"])
    assert rc == 0
    assert ": 2 frames" in capsys.readouterr().out
    with Image.open(out) as im:
        assert im.size == (64, 16)


def test_self_collide_not_ported_yet():
    """Cloth self-collision, once the scene flag that raised: now
    ``ClothScene(self_collide=True)`` steps one frame (8 substeps, the broad
    phase frozen for 8) and matches the JAX scene within the contact
    contract (pos 1e-5, vel 1e-4), launching no kernel on the CPU."""
    from wgpu_physics_engine_torch.ops import granular_kernel

    c = dict(height=12, width=12)
    j = jscenes.ClothScene(jcfg.ClothConfig(**c), self_collide=True)
    t = tscenes.ClothScene(tcfg.ClothConfig(**c), self_collide=True,
                           device="cpu")
    assert t._sc_grid.dims == j._sc_grid.dims
    for scene in (j, t):
        scene.update(1.0 / 60.0)
    np.testing.assert_allclose(t.state.pos.numpy(), np.asarray(j.state.pos),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.state.vel.numpy(), np.asarray(j.state.vel),
                               atol=1e-4, rtol=0)
    assert (cloth_kernel.LAUNCHES_FORCE, granular_kernel.LAUNCHES_FORCES) == (
        0, 0)


def test_cli_self_collide_writes_png(tmp_path, capsys):
    from PIL import Image

    from wgpu_physics_engine_torch.__main__ import main

    out = tmp_path / "cloth_sc.png"
    rc = main(["cloth", "--self-collide", "--grid", "8", "--size", "32", "48",
               "--seconds", "0.05", "--out", str(out), "--device", "cpu"])
    assert rc == 0 and "wrote" in capsys.readouterr().out
    img = np.asarray(Image.open(out).convert("RGB"))
    assert img.shape == (32, 48, 3)
    assert (img != np.round(BG * 255).astype(np.uint8)).any(-1).sum() > 10


def test_scene_on_cuda_without_cuda_raises():
    """No hidden fallback: a scene asked for CUDA on a host without it
    fails instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises((RuntimeError, AssertionError)):
        tscenes.ClothScene(tcfg.ClothConfig(height=8, width=8), device="cuda")
