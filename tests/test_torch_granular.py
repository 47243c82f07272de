"""Port parity, the granular pile: the torch ``models/granular.py`` (both
routes), the plain version of the granular kernel, ``GranularScene``, the
``granular`` CLI and ``draw_lines`` against the JAX package on the CPU.

Inputs come from a seed through numpy (or from the JAX package's own
``init_state``) and reach the port through ``particle_state_from_numpy``.
Tolerances, with their reasons:

* the gather route against JAX ``backend="xla"`` (the same candidate lists
  bit for bit, sums in another order): 1e-6 abs after one substep; over
  several, positions 1e-5 and velocities 1e-4, because a position 1 ulp
  apart (XLA on the CPU contracts ``a*b + c`` into FMA, the port rounds
  twice) moves a contact force by ``k_contact · 1.2e-7`` and the velocity
  by that times ``dt``, ~1e-6 a substep in the overlapping pairs of this
  pile, and the differences compound;
* the kernel route's plain version against JAX ``backend="pallas"`` in
  interpret mode (the same candidate sets, slab truncation included, and
  ``1/sqrt`` against the TPU kernel's rsqrt): positions 1e-5, velocities
  1e-4 over 6 substeps, JAX's own kernel-vs-gather contract
  (``tests/test_granular_pallas.py:51-54``), with equal dropped counts;
* the dense pile against the O(N²) NumPy reference: 2e-4, the reference
  test's own (``tests/test_granular_pallas.py:145``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core.state import ParticleState as JParticleState
from wgpu_physics_engine_tpu.models import granular as jgr
from wgpu_physics_engine_tpu.models import scenes as jscenes
from wgpu_physics_engine_tpu.render import camera as jcam
from wgpu_physics_engine_tpu.render import raster as jraster
from wgpu_physics_engine_torch.core.config import CameraConfig
from wgpu_physics_engine_torch.core.state import (ParticleState,
                                                  particle_state_from_numpy)
from wgpu_physics_engine_torch.models import granular as tgr
from wgpu_physics_engine_torch.models import scenes as tscenes
from wgpu_physics_engine_torch.ops import granular_kernel
from wgpu_physics_engine_torch.render import camera as tcam
from wgpu_physics_engine_torch.render import raster as traster
from wgpu_physics_engine_torch.render import geometry

DT = 1.0 / 240.0
PILE = dict(num_particles=1500, bounds=2.0, radius=0.08, restitution=0.4,
            rebuild_every=4, pallas_block=128, pallas_slab=512)
SAND = np.asarray([0.86, 0.65, 0.35], np.float32)
BLUE = np.asarray([0.0, 0.0, 1.0], np.float32)


def _cfgs(**kw):
    base = {**PILE, **kw}
    return jgr.GranularConfig(**base), tgr.GranularConfig(**base)


def _start(jc, seed=7):
    js = jgr.init_state(jc, jax.random.PRNGKey(seed))
    return js, particle_state_from_numpy(js, device="cpu")


def _close(t, j, pos_tol, vel_tol):
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), atol=pos_tol,
                               rtol=0)
    np.testing.assert_allclose(t.vel.numpy(), np.asarray(j.vel), atol=vel_tol,
                               rtol=0)


@pytest.mark.parametrize("rebuild_every,n_steps", [(4, 1), (4, 6), (1, 3)])
def test_gather_route_matches_jax_xla(rebuild_every, n_steps):
    """One substep, frozen blocks (4 + 2 substeps: a remainder block) and
    the per-substep rebuild (``substep``). Beyond one substep, rounding
    differences grow through the k = 2,000 contacts of this pile, so the
    longer runs are held to the contact-path contract (pos 1e-5, vel
    1e-4, ``tests/test_granular_pallas.py:51-54``)."""
    jc, tc = _cfgs(rebuild_every=rebuild_every)
    js, ts = _start(jc)
    jo, jd = jgr.multi_step(js, jc, jnp.float32(DT), n_steps,
                            return_stats=True, backend="xla")
    to, td = tgr.multi_step(ts, tc, DT, n_steps, return_stats=True,
                            backend="gather")
    assert int(td) == int(jd)
    if n_steps == 1:
        _close(to, jo, 1e-6, 1e-6)
    else:
        _close(to, jo, 1e-5, 1e-4)


@pytest.mark.parametrize("kw", [
    dict(),                                    # full CIV, 9 groups
    dict(thin=True, pallas_slab=768),          # thin CIV, 3 groups
    dict(civ=False, num_particles=500),        # windows; n % block != 0
    dict(pallas_slab=128),                     # undersized: dropped > 0
], ids=["civ", "thin", "windows", "undersized"])
def test_kernel_route_plain_matches_jax_pallas(kw):
    jc, tc = _cfgs(**kw)
    js, ts = _start(jc)
    jo, jd = jgr.multi_step(js, jc, jnp.float32(DT), 6, return_stats=True,
                            backend="pallas", interpret=True)
    to, td = tgr.multi_step(ts, tc, DT, 6, return_stats=True)
    assert int(td) == int(jd)
    assert (int(td) > 0) == (tc.pallas_slab == 128)
    _close(to, jo, 1e-5, 1e-4)


def test_small_grid_takes_windows_and_matches_jax():
    """dims < 3: CIV is off, the window formulation runs (and thin
    refuses, as in the JAX package)."""
    jc, tc = _cfgs(num_particles=64, bounds=0.5, radius=0.3, pallas_slab=128)
    assert min(tc.grid_spec().dims) < 3
    js, ts = _start(jc, seed=1)
    jo = jgr.multi_step(js, jc, jnp.float32(DT), 2, backend="pallas",
                        interpret=True)
    to = tgr.multi_step(ts, tc, DT, 2)
    _close(to, jo, 1e-5, 1e-4)
    for bad in (dict(thin=True, civ=False),
                dict(thin=True, bounds=0.5, radius=0.3)):
        with pytest.raises(ValueError, match="requires civ"):
            tgr.multi_step(ts, tgr.GranularConfig(
                num_particles=64, pallas_slab=128, **bad), DT, 2)


def _brute_step(pos, vel, cfg, dt):
    """O(N^2) reference with ``_frozen_substep`` semantics: penalty
    contact -> gravity -> Euler -> wall clamp & reflect."""
    d = pos[:, :, None] - pos[:, None, :]
    dist = np.sqrt((d * d).sum(axis=0))
    min_dist = 2.0 * cfg.radius
    touching = (dist < min_dist) & (dist > 1e-6)
    np.fill_diagonal(touching, False)
    inv = 1.0 / np.where(dist > 1e-6, dist, 1.0)
    w = np.where(touching, cfg.k_contact * (min_dist - dist) * inv, 0.0)
    force = (w[None] * d).sum(axis=2)
    force[1] += cfg.gravity
    vel = vel + force * dt
    pos = pos + vel * dt
    limit = cfg.bounds - cfg.radius
    hit = ((pos < -limit) & (vel < 0)) | ((pos > limit) & (vel > 0))
    vel = np.where(hit, -cfg.restitution * vel, vel)
    pos = np.clip(pos, -limit, limit)
    return pos, vel


@pytest.mark.parametrize("backend", ["kernel", "gather"])
def test_dense_pile_matches_brute_force(backend):
    """A dense 6^3 pile under gravity against the O(N^2) reference: window
    completeness (the Verlet invariant) and the op order."""
    cfg = tgr.GranularConfig(num_particles=216, bounds=1.5, radius=0.1,
                             restitution=0.3, k_contact=500.0,
                             rebuild_every=4, pallas_block=128,
                             pallas_slab=512, max_neighbors=96)
    side = 6
    g = np.stack(np.meshgrid(*[np.arange(side, dtype=np.float32)] * 3,
                             indexing="ij")).reshape(3, -1)
    pos = ((g - (side - 1) / 2) * (2.2 * cfg.radius)).astype(np.float32)
    state = ParticleState(pos=torch.tensor(pos), vel=torch.zeros(3, 216))
    out, dropped = tgr.multi_step(state, cfg, 1.0 / 480.0, 24,
                                  return_stats=True, backend=backend)
    assert int(dropped) == 0
    bp, bv = pos.copy(), np.zeros((3, 216), np.float32)
    for _ in range(24):
        bp, bv = _brute_step(bp, bv, cfg, 1.0 / 480.0)
    np.testing.assert_allclose(out.pos.numpy(), bp, atol=2e-4, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(),                                    # full CIV, 9 groups
    dict(thin=True, pallas_slab=768),          # thin CIV, 3 groups
    dict(civ=False),                           # windows
], ids=["civ", "thin", "windows"])
def test_touching_count_matches_brute_force(kw):
    """The touching candidate slots of one substep (the work a bound
    counts) are every ordered pair with 1e-12 < d2 < md², d2 taken in f32
    as the kernel takes it, when no candidate is dropped."""
    cfg = tgr.GranularConfig(**{**dict(
        num_particles=343, bounds=1.5, radius=0.1, rebuild_every=4,
        pallas_block=128, pallas_slab=512), **kw})
    side = 7
    g = np.stack(np.meshgrid(*[np.arange(side, dtype=np.float32)] * 3,
                             indexing="ij")).reshape(3, -1)
    jit = np.random.default_rng(5).uniform(-0.1, 0.1, g.shape)
    pos = ((g - (side - 1) / 2 + jit) * (1.9 * cfg.radius)).astype(np.float32)
    grid, slabs, dropped = tgr.rebuild(torch.tensor(pos),
                                       torch.zeros(3, pos.shape[1]), cfg,
                                       stats=True)
    assert int(dropped) == 0
    prm = granular_kernel.kernel_params(cfg, DT, "cpu")
    got = granular_kernel.touching_count(grid.sorted_pos, prm, slabs)
    d = pos[:, :, None] - pos[:, None, :]
    d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    md = np.float32(2.0) * np.float32(cfg.radius)
    want = int(((d2 < md * md) & (d2 > np.float32(1e-12))).sum())
    assert want > pos.shape[1]
    assert got == want
    assert granular_kernel.candidate_count(slabs, pos.shape[1]) > got


def test_sort_carry_across_blocks():
    """Three frozen blocks (4 + 4 + 2 substeps): the kernel route composes
    the per-block permutations and unsorts once; the gather route unsorts
    every block. No truncation here, so both hold the same candidate sets
    and agree to JAX's kernel-vs-gather contract."""
    _, tc = _cfgs(num_particles=500, max_neighbors=96, window=64)
    _, ts = _start(_cfgs(num_particles=500)[0], seed=3)
    ts = tgr.multi_step(ts, tc, DT, 60)            # a pile with contacts
    k, dk = tgr.multi_step(ts, tc, DT, 10, return_stats=True)
    g, dg = tgr.multi_step(ts, tc, DT, 10, return_stats=True,
                           backend="gather")
    assert int(dk) == 0 and int(dg) == 0
    assert float((k.pos - ts.pos).abs().max()) > 1e-3
    np.testing.assert_allclose(k.pos.numpy(), g.pos.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(k.vel.numpy(), g.vel.numpy(), atol=1e-4, rtol=0)


def test_traced_params_match_static():
    """k_contact/gravity/restitution as 0-d tensors equal the static config
    path bit for bit on both routes, and are live."""
    _, tc = _cfgs(num_particles=500)
    _, ts = _start(_cfgs(num_particles=500)[0], seed=0)
    kc = torch.tensor(tc.k_contact)
    g = torch.tensor(tc.gravity)
    e = torch.tensor(tc.restitution)
    for backend in ("kernel", "gather"):
        a = tgr.multi_step(ts, tc, DT, 6, backend=backend)
        b = tgr.multi_step(ts, tc, DT, 6, backend=backend, k_contact=kc,
                           gravity=g, restitution=e)
        assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)
    c = tgr.multi_step(ts, tc, DT, 6, k_contact=2.0 * kc, gravity=0.5 * g,
                       restitution=e)
    assert not torch.equal(c.pos, a.pos)


def test_dispatch_cpu_takes_plain():
    """A CPU tensor goes to the plain version and launches nothing; a
    device other than CPU or CUDA raises."""
    _, tc = _cfgs(num_particles=300)
    _, ts = _start(_cfgs(num_particles=300)[0], seed=2)
    grid, slabs, _ = tgr.rebuild(ts.pos, ts.vel, tc)
    prm = granular_kernel.kernel_params(tc, DT, "cpu")
    before = granular_kernel.LAUNCHES
    got = granular_kernel.substep_sorted(grid.sorted_pos, grid.sorted_vel,
                                         prm, slabs)
    ref = granular_kernel.substep_sorted_plain(grid.sorted_pos,
                                               grid.sorted_vel, prm, slabs)
    assert granular_kernel.LAUNCHES == before
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with pytest.raises(ValueError):
        granular_kernel.substep_sorted(grid.sorted_pos.to("meta"),
                                       grid.sorted_vel.to("meta"), prm, slabs)
    with pytest.raises(ValueError, match="CUDA"):
        granular_kernel.substep_sorted_kernel(grid.sorted_pos,
                                              grid.sorted_vel, prm, slabs)
    with pytest.raises(ValueError, match="backend"):
        tgr.multi_step(ts, tc, DT, 1, backend="pallas")


@pytest.mark.parametrize("n", [27, 1000, 1500])
def test_init_state_lattice(n):
    """The lattice is the JAX package's (including its f32 rounding of the
    cube root: 27 particles make a 3-lattice); the jitter, drawn from a
    torch.Generator, stays within ±0.2 of the spacing of JAX's lattice."""
    jc, tc = _cfgs(num_particles=n)
    side = int(np.ceil(np.float32(n ** (1.0 / 3.0))))
    scale = 1.6 * tc.bounds / side
    a = tgr.init_state(tc, torch.Generator().manual_seed(0), device="cpu")
    b = tgr.init_state(tc, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(a.pos, b.pos) and not a.vel.any()
    j = np.asarray(jgr.init_state(jc, jax.random.PRNGKey(0)).pos)
    assert a.pos.shape == (3, n) and a.pos.dtype == torch.float32
    assert np.abs(a.pos.numpy() - j).max() <= 0.4 * scale * (1 + 1e-5)
    assert np.abs(a.pos.numpy() - j).max() > 0.05 * scale


SCENE_CFG = dict(num_particles=400, bounds=2.0, radius=0.08)


@pytest.fixture(scope="module")
def scenes_pair():
    j = jscenes.GranularScene(config=jgr.GranularConfig(**SCENE_CFG))
    t = tscenes.GranularScene(config=tgr.GranularConfig(**SCENE_CFG),
                              device="cpu")
    t.state = particle_state_from_numpy(j.state, device="cpu")
    for s in (j, t):
        s.set_gravity(-6.0)
        s.set_k_contact(1500.0)
        s.set_restitution(0.3)
        s.update(1 / 60)            # 4 substeps
        s.update(1.0)               # clamped to max_substeps = 8
        s.simulate(0.05)            # 12 substeps, one call
    return j, t


def test_scene_frame_contract_and_sliders(scenes_pair):
    """update/simulate with the material sliders: the port's kernel route
    (plain version on the CPU) against the JAX scene (its XLA route off
    the TPU), JAX's kernel-vs-gather contract; the sliders are device
    tensors and are live."""
    j, t = scenes_pair
    assert t.state.pos.device.type == "cpu" and t.dropped == j.dropped == 0
    _close(t.state, j.state, 1e-5, 1e-4)
    assert float(t.params.gravity) == -6.0 and t.instance_count == 400
    assert isinstance(t.k_contact, torch.Tensor)
    runs = []
    for changes in ({}, dict(gravity=-1.0, restitution=0.9)):
        s = tscenes.GranularScene(config=tgr.GranularConfig(**SCENE_CFG),
                                  device="cpu")
        s.state = t.state
        s.reconfigure(**changes)
        s.simulate(0.05)
        runs.append(s.state.pos)
    assert not torch.equal(runs[0], runs[1])
    assert granular_kernel.LAUNCHES == 0


@pytest.mark.parametrize("hw", [(48, 64), (40, 52)])
def test_scene_render_matches(scenes_pair, hw):
    j, t = scenes_pair
    h, w = hw
    j.resize(w, h)
    t.resize(w, h)
    ref = j.render(h, w)
    got = t.render(h, w)
    assert got.shape == ref.shape == (h, w, 3) and np.isfinite(got).all()
    d = np.abs(got - ref).max(-1)
    assert (d <= 1e-4).mean() >= 0.999, (d > 1e-4).mean()
    assert (np.abs(got - SAND).max(-1) < 1e-6).sum() > 10
    assert (got == BLUE).all(-1).sum() > 10


def test_draw_lines_matches_jax():
    look = dict(radius=7.0, theta=0.4, phi=0.35)
    jc = jcam.make_camera(jscenes.cfg.CameraConfig(**look), aspect=80 / 56)
    tc = tcam.make_camera(CameraConfig(**look), aspect=80 / 56)
    segs = geometry.wireframe_box(2.0).reshape(-1, 2, 3)
    ref = jraster.draw_lines(jraster.clear(56, 80), jc, jnp.asarray(segs))
    got = traster.draw_lines(traster.clear(56, 80), tc, segs)
    on = (got.color.numpy() == BLUE).all(-1)
    assert on.sum() > 100
    d = np.abs(got.color.numpy() - np.asarray(ref.color)).max(-1)
    assert (d <= 1e-4).mean() >= 0.999
    both = on & (np.asarray(ref.color) == BLUE).all(-1)
    np.testing.assert_allclose(got.depth.numpy()[both],
                               np.asarray(ref.depth)[both], rtol=1e-5)


def test_cli_granular_writes_png(tmp_path, capsys):
    from PIL import Image

    from wgpu_physics_engine_torch.__main__ import main

    out = tmp_path / "pile.png"
    rc = main(["granular", "--device", "cpu", "--particles", "400",
               "--seconds", "0.05", "--size", "128", "128", "--out", str(out)])
    assert rc == 0 and "wrote" in capsys.readouterr().out
    img = np.asarray(Image.open(out).convert("RGB")).astype(np.int16)
    assert img.shape == (128, 128, 3)
    sand = (np.abs(img - np.round(SAND * 255)).max(-1) <= 1).sum()
    blue = (img == [0, 0, 255]).all(-1).sum()
    assert sand > 0 and blue > 100


def test_granular_scene_on_cuda_without_cuda_raises():
    """No hidden fallback: a scene asked for CUDA on a host without it
    fails instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises((RuntimeError, AssertionError)):
        tscenes.GranularScene(config=tgr.GranularConfig(num_particles=64),
                              device="cuda")


def test_particle_state_from_numpy():
    js = JParticleState(pos=jnp.arange(6.0).reshape(3, 2),
                        vel=jnp.ones((3, 2)))
    ts = particle_state_from_numpy(js, device="cpu")
    assert ts.pos.dtype == torch.float32 and ts.pos.device.type == "cpu"
    assert np.array_equal(ts.pos.numpy(), np.asarray(js.pos))
    assert np.array_equal(ts.vel.numpy(), np.asarray(js.vel))
