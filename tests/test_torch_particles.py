"""Port parity, the free-particle box (sim 4): ``models.particles``, the
untiled sphere raster's plain version (K4), ``draw_instanced_spheres`` in
its three modes, ``FreeParticleScene`` and the ``particles`` CLI, on the
CPU against the JAX package.

The five tests of ``tests/test_particles.py`` run on the port; then port
against JAX ``particles.substep`` / ``multi_step`` with JAX's initial state
carried across (``jax.random`` bits cannot be reproduced): one substep
1e-6, 180 substeps through wall bounces pos 1e-4 and vel 1e-3 (the
contract of ``tests/test_cloth_vs_oracle.py:74-102``; XLA on the CPU
contracts ``a*b + c`` into FMA, torch does not).

K4's plain version is held to ``raster_pallas.sphere_raster(...,
interpret=True)``: winners equal, ``tmin`` within 1e-5 plus two ulps of
``b`` through the condition number (the bound of
``tests/test_torch_render.py``). Frames are held to JAX's CPU route
(``use_kernel=False``): the winners agree on >= 99.9% of pixels, and where
they agree the colour is within 1e-5 plus twice the change that moving
``tmin`` by twice that ulp bound makes to the port's own colour. The flat
mode does not depend on ``tmin`` and is held to 1e-5. The textured and lit
modes do: a sphere of radius ~1 seen from ~25 away is hit at a ``t``
whose float32 error is ~20 ulps of ``b`` (``1 + |b| / sqrt(b² - c)``),
and JAX's route (a matmul, FMA-contracted, ``_safe_sqrt``) and the port's
round ``b`` apart by an ulp, which moves the hit point by up to ~4e-4 at a
silhouette and the texture sample or the Phong highlight with it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu import render as JR
from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.core.state import ParticleParams as JParams
from wgpu_physics_engine_tpu.core.state import ParticleState as JState
from wgpu_physics_engine_tpu.models import particles as jparticles
from wgpu_physics_engine_tpu.models import scenes as jscenes
from wgpu_physics_engine_tpu.ops import raster_pallas
from wgpu_physics_engine_tpu.render import texture as JT
from wgpu_physics_engine_torch import render as TR
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.core import state as tstate
from wgpu_physics_engine_torch.core.state import ParticleParams, ParticleState
from wgpu_physics_engine_torch.models import particles
from wgpu_physics_engine_torch.models import scenes as tscenes
from wgpu_physics_engine_torch.ops import raster_kernel


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# --- the five tests of tests/test_particles.py, on the port ---

def test_free_fall_matches_analytic():
    c = tcfg.FreeParticleConfig(num_particles=4)
    params = ParticleParams.from_config(c, device="cpu")
    state = particles.init_state(c, torch.Generator().manual_seed(0),
                                 device="cpu")
    state = state._replace(vel=torch.zeros_like(state.vel))
    out = particles.substep(state, params, 1.0 / 60.0)
    np.testing.assert_allclose(_np(out.vel[1]), -9.81 / 60.0, rtol=1e-5)
    np.testing.assert_allclose(_np(out.pos[1]), c.radius - 9.81 / 60.0**2,
                               rtol=1e-5)


def _one_at_the_wall():
    c = tcfg.FreeParticleConfig(num_particles=1)
    params = ParticleParams.from_config(c, device="cpu")._replace(
        gravity=torch.zeros(3))
    state = ParticleState(pos=torch.tensor([[9.5], [0.0], [0.0]]),
                          vel=torch.tensor([[60.0], [0.0], [0.0]]))
    return state, params


def test_wall_bounce_correct_mode():
    """Documented-correct semantics: clamp + velocity flip."""
    state, params = _one_at_the_wall()
    out = particles.substep(state, params, 0.05)
    # pos would be 12.5 > bounds - r = 9 → clamped, velocity flipped
    assert float(out.pos[0, 0]) == 9.0
    assert float(out.vel[0, 0]) == -60.0


def test_wall_bounce_bug_compat_mode():
    """The reference's quirk: the clamp is lost, only the flip persists."""
    state, params = _one_at_the_wall()
    out = particles.substep(state, params, 0.05, bug_compat=True)
    np.testing.assert_allclose(float(out.pos[0, 0]), 12.5, rtol=1e-6)
    assert float(out.vel[0, 0]) == -60.0


def test_multi_step_matches_numpy_oracle():
    c = tcfg.FreeParticleConfig(num_particles=16)
    params = ParticleParams.from_config(c, device="cpu")
    state = particles.init_state(c, torch.Generator().manual_seed(42),
                                 device="cpu")
    dt = 1.0 / 60.0
    pos, vel = _np(state.pos).copy(), _np(state.vel).copy()
    for _ in range(600):
        pos, vel = particles.oracle_substep(pos, vel, c.gravity, c.bounds,
                                            c.radius, dt)
    out = particles.multi_step(state, params, dt, 600)
    np.testing.assert_allclose(_np(out.pos), pos, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(out.vel), vel, atol=1e-4, rtol=1e-4)


def test_particles_stay_in_box():
    c = tcfg.FreeParticleConfig(num_particles=64)
    params = ParticleParams.from_config(c, device="cpu")
    state = particles.init_state(c, torch.Generator().manual_seed(7),
                                 device="cpu")
    out = particles.multi_step(state, params, 1.0 / 120.0, 2000)
    limit = c.bounds - c.radius
    assert np.all(np.abs(_np(out.pos)) <= limit + 1e-4)
    assert np.all(np.isfinite(_np(out.vel)))


# --- the port against the JAX package ---

def test_init_state_and_params_match():
    """The layout of the initial state (all at (0, r, 0), velocities in
    ±speed) and the params, bit for bit through the numpy carry-across."""
    c = tcfg.FreeParticleConfig(num_particles=500)
    jc = jcfg.FreeParticleConfig(num_particles=500)
    s = particles.init_state(c, torch.Generator().manual_seed(1), device="cpu")
    js = jparticles.init_state(jc, jax.random.key(1))
    np.testing.assert_array_equal(_np(s.pos), np.asarray(js.pos))
    v = _np(s.vel)
    assert v.shape == (3, 500) and np.abs(v).max() <= c.initial_speed
    assert v.std() > 0.4 * c.initial_speed
    p = ParticleParams.from_config(c, device="cpu")
    jp = JParams.from_config(jc)
    q = tstate.particle_params_from_numpy(jp, device="cpu")
    for f in ParticleParams._fields:
        np.testing.assert_array_equal(_np(getattr(p, f)),
                                      np.asarray(getattr(jp, f)))
        np.testing.assert_array_equal(_np(getattr(q, f)), _np(getattr(p, f)))


def _carried(n, seed, bug_compat):
    jc = jcfg.FreeParticleConfig(num_particles=n, bug_compat=bug_compat)
    js = jparticles.init_state(jc, jax.random.key(seed))
    jp = JParams.from_config(jc)
    return (js, jp, tstate.particle_state_from_numpy(js, device="cpu"),
            tstate.particle_params_from_numpy(jp, device="cpu"))


@pytest.mark.parametrize("bug_compat", [False, True])
def test_substep_matches_jax(bug_compat):
    js, jp, ts, tp = _carried(64, 3, bug_compat)
    # start some particles beyond the walls, moving outward
    pos = np.asarray(js.pos).copy()
    pos[:, :16] = np.random.default_rng(0).uniform(-9.5, 9.5, (3, 16))
    js = JState(pos=jnp.asarray(pos), vel=js.vel)
    ts = ts._replace(pos=torch.tensor(pos))
    ref = jparticles.substep(js, jp, jnp.float32(1 / 60), bug_compat)
    got = particles.substep(ts, tp, 1 / 60, bug_compat)
    np.testing.assert_allclose(_np(got.pos), np.asarray(ref.pos), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(_np(got.vel), np.asarray(ref.vel), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("bug_compat", [False, True])
def test_multi_step_matches_jax_through_bounces(bug_compat):
    js, jp, ts, tp = _carried(64, 5, bug_compat)
    ref = jparticles.multi_step(js, jp, jnp.float32(1 / 60), 180,
                                bug_compat=bug_compat)
    got = particles.multi_step(ts, tp, 1 / 60, 180, bug_compat=bug_compat)
    np.testing.assert_allclose(_np(got.pos), np.asarray(ref.pos), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(_np(got.vel), np.asarray(ref.vel), atol=1e-3,
                               rtol=1e-3)
    # through wall bounces: gravity leaves x and z alone, so a flipped sign
    # there is a bounce
    flipped = np.sign(np.asarray(ref.vel)[[0, 2]]) != np.sign(
        np.asarray(js.vel)[[0, 2]])
    assert flipped.any(0).mean() > 0.3, flipped.any(0).mean()


# --- K4: the untiled sphere raster ---

def _rays(h, w, radius=40.0):
    jc = JR.make_camera(jcfg.CameraConfig(radius=radius, phi=0.3, theta=0.3),
                        aspect=w / h)
    tc = TR.Camera(*(torch.tensor(np.asarray(a)) for a in jc))
    je, jd = JR.pixel_rays(jc, h, w)
    return jc, tc, je, jd


def _centers(n, seed, spread=9.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-spread, spread, (n, 3)).astype(np.float32)


def _t_ulp(ocb, inst, dirs):
    """Per pixel, how far ``t`` moves when ``b`` moves by one ulp
    (``|b| 2^-23 (1 + |b| / sqrt(b² - c))``), from the winner's entry."""
    o = _np(ocb).astype(np.float64)[:, np.clip(_np(inst), 0, None)]
    d = _np(dirs).astype(np.float64)
    b = (d * o[:3]).sum(0)
    disc = np.maximum(b * b - o[3], 1e-30)
    return np.abs(b) * 2.0 ** -23 * (1.0 + np.abs(b) / np.sqrt(disc))


@pytest.mark.parametrize("n,radius", [(5, 2.0), (300, 0.6)])
def test_untiled_plain_matches_pallas_interpret(n, radius):
    h, w = 24, 40
    jc, tc, je, jd = _rays(h, w, radius=25.0)
    centers = _centers(n, n)
    rt, ri = raster_pallas.sphere_raster(je, jd, jnp.asarray(centers), radius,
                                         jc.znear, interpret=True)
    td = torch.tensor(np.asarray(jd))
    gt, gi = raster_kernel.sphere_raster_untiled(
        tc.eye, td, torch.tensor(centers), radius, tc.znear)
    assert gi.dtype == torch.int32 and gt.shape == (h, w)
    hit = _np(gi) >= 0
    assert hit.sum() > 20
    np.testing.assert_array_equal(_np(gi), np.asarray(ri))
    ocb = raster_kernel.untiled_prologue(tc.eye, torch.tensor(centers), radius)
    excess = (np.abs(_np(gt)[hit] - np.asarray(rt)[hit])
              - (1e-5 + 2.0 * _t_ulp(ocb, gi, td)[hit]))
    assert (excess <= 0).all(), excess.max()
    assert np.isinf(_np(gt)[~hit]).all()


def test_untiled_route_limits():
    """The dispatcher's contract: at most MAX_INSTANCES instances; no
    kernel launch from a CPU tensor; the plain version equals the tiled
    route's winners on the same rays."""
    assert raster_kernel.MAX_INSTANCES == 16384
    _, tc, _, jd = _rays(8, 8)
    td = torch.tensor(np.asarray(jd))
    with pytest.raises(AssertionError):
        raster_kernel.sphere_raster_untiled(
            tc.eye, td, torch.zeros((16385, 3)), 0.1, tc.znear)
    before = raster_kernel.LAUNCHES_UNTILED
    h, w = 24, 40
    _, tc, _, jd = _rays(h, w, radius=25.0)
    td = torch.tensor(np.asarray(jd))
    centers = torch.tensor(_centers(300, 300))
    ut, ui = raster_kernel.sphere_raster_untiled(tc.eye, td, centers, 0.6,
                                                 tc.znear)
    wins, ocb, order, rect = raster_kernel.tiled_prologue(
        tc.view[:3, :3], tc.eye, centers, 0.6, tc.znear,
        torch.tan(tc.fovy_rad / 2.0), tc.aspect, h, w)
    bt, bi, _ = raster_kernel.sphere_raster_binned(wins, ocb, rect, td,
                                                   tc.znear)
    ids = torch.where(bi >= 0, order[bi.clamp_min(0).long()], -1)
    assert torch.equal(ids, ui)
    assert torch.equal(bt, ut)
    assert raster_kernel.LAUNCHES_UNTILED == before


def _routes(monkeypatch):
    """Count which raster route each draw takes (on the CPU both take
    their plain versions)."""
    calls = {"untiled": 0, "tiled": 0}
    untiled, binned = (raster_kernel.sphere_raster_untiled,
                       raster_kernel.sphere_raster_binned)

    def count_untiled(*a, **k):
        calls["untiled"] += 1
        return untiled(*a, **k)

    def count_binned(*a, **k):
        calls["tiled"] += 1
        return binned(*a, **k)

    monkeypatch.setattr(raster_kernel, "sphere_raster_untiled", count_untiled)
    monkeypatch.setattr(raster_kernel, "sphere_raster_binned", count_binned)
    return calls


MODES = {
    "flat": dict(flat_color=(1.0, 0.0, 0.0)),
    "textured": dict(flat_color=None, texture="moon1024"),
    "lit": dict(flat_color=(0.8, 0.3, 0.2), lit=True),
}


def _draw_both(h, w, mode, centers, radius):
    """JAX's CPU route and the port's frame of ``centers`` in ``mode``, and
    a function that draws the port's frame again."""
    jc, tc, _, _ = _rays(h, w, radius=25.0)
    kw = dict(MODES[mode])
    jkw, tkw = dict(kw), dict(kw)
    if "texture" in kw:
        tex = np.asarray(JT.get(kw["texture"]))
        jkw["texture"], tkw["texture"] = jnp.asarray(tex), torch.tensor(tex)
    ref = JR.draw_instanced_spheres(JR.clear(h, w), jc, jnp.asarray(centers),
                                    radius, jcfg.LightConfig(),
                                    use_kernel=False, **jkw)

    def draw():
        return TR.draw_instanced_spheres(TR.clear(h, w), tc,
                                         torch.tensor(centers), radius,
                                         tcfg.LightConfig(), **tkw)
    return draw(), ref, draw


def _tmin_sensitivity(monkeypatch, draw):
    """Per pixel, the largest change of the image ``draw()`` returns when
    the untiled raster's ``tmin`` moves by twice its ulp bound
    (:func:`_t_ulp`) either way."""
    orig = raster_kernel.sphere_raster_untiled
    base = draw()
    sens = np.zeros(base.shape[:-1])
    for sign in (1.0, -1.0):
        def shifted(eye, dirs, centers, radius, znear, sign=sign):
            t, i = orig(eye, dirs, centers, radius, znear)
            ocb = raster_kernel.untiled_prologue(eye, centers, radius)
            dt = torch.tensor(2.0 * _t_ulp(ocb, i, dirs), dtype=torch.float32)
            return t + sign * dt, i
        monkeypatch.setattr(raster_kernel, "sphere_raster_untiled", shifted)
        sens = np.maximum(sens, np.abs(draw() - base).max(-1))
    monkeypatch.setattr(raster_kernel, "sphere_raster_untiled", orig)
    return sens


@pytest.mark.parametrize("mode", list(MODES))
def test_draw_instanced_spheres_matches_jax_on_ragged_frame(mode, monkeypatch):
    h, w = 40, 48
    centers = _centers(60, 11, spread=6.0)
    calls = _routes(monkeypatch)
    got, ref, draw = _draw_both(h, w, mode, centers, 1.2)
    assert calls == {"untiled": 1, "tiled": 0}
    monkeypatch.undo()
    hit, rhit = _np(got.depth) < 1.0, np.asarray(ref.depth) < 1.0
    assert hit.mean() > 0.1
    assert (hit == rhit).mean() >= 0.999
    # winners agree where the depths do (a different winner moves the depth)
    same = hit & rhit & (np.abs(_np(got.depth) - np.asarray(ref.depth)) <= 1e-6)
    assert same.sum() >= 0.999 * hit.sum()
    d = np.abs(_np(got.color) - np.asarray(ref.color)).max(-1)
    sens = _tmin_sensitivity(monkeypatch, lambda: _np(draw().color))
    if mode == "flat":
        assert sens.max() == 0.0
    excess = d - (1e-5 + 2.0 * sens)
    assert (excess[same] <= 0).all(), excess[same].max()
    assert (d[~hit & ~rhit] == 0).all()
    if mode != "flat":       # shading varies over a sphere
        assert _np(got.color)[hit].std(0).max() > 0.02


def test_draw_instanced_spheres_aligned_frame_takes_tiled_route(monkeypatch):
    calls = _routes(monkeypatch)
    got, ref, _ = _draw_both(16, 128, "textured", _centers(40, 12, 6.0), 1.2)
    assert calls == {"untiled": 0, "tiled": 1}
    hit = _np(got.depth) < 1.0
    assert hit.sum() > 50
    assert (hit == (np.asarray(ref.depth) < 1.0)).mean() >= 0.999
    # more instances than the untiled table holds: tiled on a ragged frame
    calls["tiled"] = 0
    _, tc, _, _ = _rays(8, 12)
    TR.draw_instanced_spheres(TR.clear(8, 12), tc,
                              torch.tensor(_centers(16385, 13)), 0.05)
    assert calls == {"untiled": 0, "tiled": 1}


# --- the scene and the CLI ---

def _scenes(n=10, bug_compat=False, seed=4):
    jc = jcfg.FreeParticleConfig(num_particles=n, bug_compat=bug_compat)
    tc = tcfg.FreeParticleConfig(num_particles=n, bug_compat=bug_compat)
    j = jscenes.FreeParticleScene(config=jc, seed=seed)
    t = tscenes.FreeParticleScene(config=tc, seed=seed, device="cpu")
    # JAX's draw
    t.state = tstate.particle_state_from_numpy(j.state, device="cpu")
    return j, t


def _frames_close(got, ref, sens):
    """The scene's frames: within 1e-5 plus twice the ``tmin`` sensitivity
    on >= 99.9% of pixels (a line pixel may flip)."""
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    d = np.abs(got - ref).max(-1)
    assert (d <= 1e-5 + 2.0 * sens).mean() >= 0.999, (d > 1e-5 + 2.0 * sens).mean()


def _render_close(j, t, h, w, monkeypatch):
    """The port scene's frame against the JAX scene's, from JAX's state."""
    t.state = tstate.particle_state_from_numpy(j.state, device="cpu")
    ref = j.render(h, w)
    got = t.render(h, w)
    assert (np.abs(got - np.asarray([0.05, 0.05, 0.08])).max(-1) > 0.01).sum() > 30
    _frames_close(got, ref, _tmin_sensitivity(monkeypatch,
                                              lambda: t.render(h, w)))


@pytest.mark.parametrize("bug_compat", [False, True])
def test_scene_simulate_and_render_match_jax(bug_compat, monkeypatch):
    j, t = _scenes(bug_compat=bug_compat)
    assert t.state.pos.device.type == "cpu"
    for s in (j, t):
        s.simulate(3.0)
    np.testing.assert_allclose(_np(t.state.pos), np.asarray(j.state.pos),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(t.state.vel), np.asarray(j.state.vel),
                               atol=1e-3, rtol=1e-3)
    if not bug_compat:
        assert np.abs(_np(t.state.pos)).max() <= 9.0 + 1e-5
    # the default frame's shape (600 x 800) at a tenth of its size: ragged
    _render_close(j, t, 60, 80, monkeypatch)


def test_scene_update_and_sliders_match_jax(monkeypatch):
    j, t = _scenes(n=12)
    for s in (j, t):
        s.update(1.0 / 30.0)
        s.set_gravity((0.0, -2.0, 1.0))
        s.set_time_scale(0.5)
        s.set_bounds(6.0)
        s.set_radius(0.8)
        s.orbit(d_theta=0.2)
        s.update(1.0 / 30.0)
        s.simulate(1.0)
    for f in ("gravity", "bounds", "radius", "damping"):
        np.testing.assert_array_equal(_np(getattr(t.params, f)),
                                      np.asarray(getattr(j.params, f)))
    np.testing.assert_allclose(_np(t.state.pos), np.asarray(j.state.pos),
                               atol=1e-4, rtol=1e-4)
    assert np.abs(_np(t.state.pos)).max() <= 6.0 - 0.8 + 1e-5
    _render_close(j, t, 36, 52, monkeypatch)


def test_cli_particles_writes_png(tmp_path, capsys, monkeypatch):
    from PIL import Image

    from wgpu_physics_engine_torch.__main__ import main

    calls = _routes(monkeypatch)
    out = tmp_path / "box.png"
    rc = main(["particles", "--device", "cpu", "--size", "48", "64",
               "--seconds", "0.5", "--out", str(out)])
    assert rc == 0 and "wrote" in capsys.readouterr().out
    assert calls == {"untiled": 1, "tiled": 0}
    img = np.asarray(Image.open(out).convert("RGB"))
    assert img.shape == (48, 64, 3)
    assert (img == [0, 0, 255]).all(-1).sum() > 20          # the box
    assert raster_kernel.LAUNCHES_UNTILED == 0
