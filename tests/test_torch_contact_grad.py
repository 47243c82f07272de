"""Port parity, contact gradients: the plain versions of K11
(``contact_forces_sorted``) and K12 (``contact_force_jvp_sorted``) and the
torch ``granular.multi_step_diff`` against the JAX package on the CPU (its
Pallas kernels in interpret mode), plus the port's example
``examples/inverse_granular.py``.

The configuration is ``tests/test_granular_grad.py``'s (N = 400 in a unit
box, rebuild every 4, block 128, slab 256), settled 60 substeps by the JAX
package and handed to the port as numpy arrays; the loss weights come from a
numpy seed. Tolerances, with their reasons:

* K11 and K12 against JAX: 1e-5 relative to the largest component (the
  same candidate sets; the port sums each group in double and takes
  ``1/sqrt`` where the TPU kernel takes rsqrt, and its J·u is written by
  hand where JAX differentiates the pair expressions);
* K12 against ``torch.autograd.functional.jvp`` of K11's plain version, and
  the symmetry ``⟨Ju, v⟩ = ⟨u, Jv⟩``: 1e-5 relative;
* ``multi_step_diff``'s primal against the port's ``multi_step``: pos 5e-7,
  vel 5e-6 (``tests/test_granular_grad.py:109-112``);
* its gradients against JAX's ``multi_step_diff`` and against a dense
  O(N²) torch mirror under ``torch.autograd``: 1e-4 max-relative
  (``tests/test_granular_grad.py:150-153``: fp32 sums in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core.state import ParticleState as JState
from wgpu_physics_engine_tpu.models import granular as jgr
from wgpu_physics_engine_tpu.ops import granular_pallas as gp
from wgpu_physics_engine_torch.core.state import ParticleState
from wgpu_physics_engine_torch.models import broadphase as tbp
from wgpu_physics_engine_torch.models import granular as tgr
from wgpu_physics_engine_torch.ops import granular_kernel as gk

N = 400
DT = 1.0 / 240.0
N_STEPS = 6       # rebuild_every=4: one full segment and a remainder
BASE = dict(num_particles=N, bounds=1.0, radius=0.05, rebuild_every=4,
            pallas_block=128, pallas_slab=256, grid_capacity=16)
NAMES = ("pos", "vel", "dt", "kc", "grav", "e")


def _cfgs(**kw):
    return jgr.GranularConfig(**BASE, **kw), tgr.GranularConfig(**BASE, **kw)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def setup():
    jc, _ = _cfgs()
    js = jgr.multi_step(jgr.init_state(jc, jax.random.PRNGKey(0)), jc,
                        jnp.float32(DT), 60)
    _, dropped = jgr.multi_step(js, jc, jnp.float32(DT), N_STEPS,
                                return_stats=True)
    assert int(dropped) == 0          # the gradient contract's precondition
    rng = np.random.default_rng(3)
    wp, wv = (rng.standard_normal((3, N)).astype(np.float32)
              for _ in range(2))
    return np.asarray(js.pos), np.asarray(js.vel), wp, wv


def _jax_structs(pos, jc):
    """JAX's rebuild of the differentiable path (``_diff_structs``)."""
    p = jnp.asarray(pos)
    order, cidf, off, posc, _, civ, n_pad = jgr._diff_structs(
        p, jnp.zeros_like(p), jc)
    return order, cidf, off, posc, civ, n_pad


@pytest.mark.parametrize("thin", [False, True], ids=["full", "thin"])
def test_forces_and_jvp_plain_match_jax(setup, thin):
    """K11 and K12's plain versions against JAX's kernels (interpret
    mode) on the same sorted state and candidate set."""
    pos, _, _, _ = setup
    jc, tc = _cfgs(thin=thin)
    order, cidf, off, posc, civ, n_pad = _jax_structs(pos, jc)
    md, kc = 2.0 * np.float32(jc.radius), np.float32(jc.k_contact)
    u = np.random.default_rng(5).standard_normal((n_pad, 3)).astype(np.float32)
    u[N:] = 0.0
    f_j = gp.contact_forces_sorted(
        jnp.concatenate([posc.T, cidf[None]]), posc, cidf[:, None], off, md,
        kc, block=jc.pallas_block, slab=jc.pallas_slab, n_real=N,
        interpret=True, thin=thin, civ=civ)
    ft_j = gp.contact_force_jvp_sorted(
        jnp.concatenate([posc.T, jnp.asarray(u).T, cidf[None],
                         jnp.zeros((1, n_pad), jnp.float32)]),
        jnp.concatenate([posc, jnp.asarray(u)], axis=1), cidf[:, None], off,
        md, kc, block=jc.pallas_block, slab=jc.pallas_slab, n_real=N,
        interpret=True, civ=civ)
    tpos = torch.tensor(pos)
    grid, slabs, _ = tgr.rebuild(tpos, torch.zeros_like(tpos), tc)
    assert np.array_equal(grid.order.numpy(), np.asarray(order))
    f_t = gk.contact_forces_sorted(grid.sorted_pos, md, kc, slabs)
    ft_t = gk.contact_force_jvp_sorted(grid.sorted_pos,
                                       torch.tensor(u[:N].T.copy()), md, kc,
                                       slabs)
    assert float(f_t.abs().max()) > 1.0          # contacts are active
    assert _rel(f_t.numpy(), np.asarray(f_j)[:N].T) <= 1e-5
    assert _rel(ft_t[:3].numpy(), np.asarray(ft_j)[:N, :3].T) <= 1e-5
    assert _rel(ft_t[3:].numpy(), np.asarray(ft_j)[:N, 3:].T) <= 1e-5
    assert torch.equal(ft_t[:3], f_t)


@pytest.mark.parametrize("thin", [False, True], ids=["full", "thin"])
def test_jvp_plain_matches_autograd_and_is_symmetric(setup, thin):
    """K12's hand-written J·u against ``torch.autograd.functional.jvp``
    of K11's plain version, and ⟨Ju, v⟩ = ⟨u, Jv⟩ (no slab entry
    dropped)."""
    pos, _, _, _ = setup
    _, tc = _cfgs(thin=thin)
    tpos = torch.tensor(pos)
    grid, slabs, dropped = tgr.rebuild(tpos, torch.zeros_like(tpos), tc,
                                       stats=True)
    assert int(dropped) == 0
    p = grid.sorted_pos
    md, kc = 2.0 * tc.radius, tc.k_contact
    rng = np.random.default_rng(7)
    u, v = (torch.tensor(rng.standard_normal((3, N)).astype(np.float32))
            for _ in range(2))
    _, ju_ref = torch.autograd.functional.jvp(
        lambda q: gk.contact_forces_sorted_plain(q, md, kc, slabs), (p,), (u,))
    ju = gk.contact_force_jvp_sorted(p, u, md, kc, slabs)[3:]
    jv = gk.contact_force_jvp_sorted(p, v, md, kc, slabs)[3:]
    assert _rel(ju.numpy(), ju_ref.numpy()) <= 1e-5
    a = float((ju.double() * v.double()).sum())
    b = float((u.double() * jv.double()).sum())
    assert abs(a - b) <= 1e-5 * abs(a)


def test_primal_matches_multi_step(setup):
    pos, vel, _, _ = setup
    _, tc = _cfgs()
    s = ParticleState(pos=torch.tensor(pos), vel=torch.tensor(vel))
    prod = tgr.multi_step(s, tc, DT, N_STEPS)
    diff = tgr.multi_step_diff(s, tc, DT, N_STEPS)
    np.testing.assert_allclose(diff.pos.numpy(), prod.pos.numpy(), atol=5e-7,
                               rtol=0)
    np.testing.assert_allclose(diff.vel.numpy(), prod.vel.numpy(), atol=5e-6,
                               rtol=0)


def _torch_grads(pos, vel, wp, wv, tc, fn):
    """Gradients of ``<out.pos, wp> + <out.vel, wv>`` with respect to
    (pos, vel, dt, k_contact, gravity, restitution) through ``fn``."""
    leaves = [torch.tensor(pos), torch.tensor(vel)] + [
        torch.tensor(v, dtype=torch.float32)
        for v in (DT, tc.k_contact, tc.gravity, tc.restitution)]
    for t in leaves:
        t.requires_grad_()
    p, v = fn(*leaves)
    loss = (p * torch.tensor(wp)).sum() + (v * torch.tensor(wv)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def _diff(tc):
    def fn(pos, vel, dt, kc, grav, e):
        out = tgr.multi_step_diff(ParticleState(pos=pos, vel=vel), tc, dt,
                                  N_STEPS, k_contact=kc, gravity=grav,
                                  restitution=e)
        return out.pos, out.vel
    return fn


def _dense(tc):
    """The dense O(N²) mirror in torch: the same thin or full CIV
    candidacy (cid intervals over the frozen sorted structure of each
    segment), the same integrate, differentiated by ``torch.autograd``."""
    spec = tc.grid_spec()
    bounds = gk.civ_bounds(spec, tc.thin)

    def segment(pos, vel, dt, kc, grav, e, length):
        grid, _, _ = tgr.rebuild(pos.detach(), vel.detach(), tc)
        order = grid.order.long()
        cid = grid.sorted_cid.long()
        dc = cid[None, :] - cid[:, None]
        valid = torch.zeros(dc.shape, dtype=torch.bool)
        for lo, hi in bounds:
            valid |= (dc >= lo) & (dc <= hi)
        valid &= ~torch.eye(N, dtype=torch.bool)
        prm = gk.kernel_params(tc, dt, "cpu", kc, grav, e)
        md = prm[0]
        p, v = pos[:, order], vel[:, order]
        for _ in range(length):
            d = p[:, :, None] - p[:, None, :]
            d2 = (d * d).sum(0)
            touching = valid & (d2 < md * md) & (d2 > 1e-12)
            inv = 1.0 / torch.sqrt(torch.where(touching, d2, 1.0))
            w = torch.where(touching, prm[1] * (md * inv - 1.0), 0.0)
            p, v = tgr._mirror_substep(p, v, (w[None] * d).sum(2), prm)
        inv_o = tbp._inverse(grid.order)
        return p[:, inv_o], v[:, inv_o]

    def fn(pos, vel, dt, kc, grav, e):
        for length in tgr._segments(tc, N_STEPS):
            pos, vel = segment(pos, vel, dt, kc, grav, e, length)
        return pos, vel
    return fn


@pytest.fixture(scope="module", params=[False, True], ids=["full", "thin"])
def hot_grads(request, setup):
    """Gradients on the hot state (velocities × 8: wall bounces fire inside
    the horizon, so restitution's cotangent is nonzero), from JAX's
    ``multi_step_diff`` and from the port's."""
    pos, vel, wp, wv = setup
    thin = request.param
    jc, tc = _cfgs(thin=thin)
    vel = (vel * np.float32(8.0)).astype(np.float32)

    def loss(p, v, dt, kc, grav, e):
        out = jgr.multi_step_diff(JState(pos=p, vel=v), jc, dt, N_STEPS,
                                  k_contact=kc, gravity=grav, restitution=e)
        return jnp.sum(out.pos * wp) + jnp.sum(out.vel * wv)

    g_j = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(
        jnp.asarray(pos), jnp.asarray(vel), jnp.float32(DT),
        jnp.float32(jc.k_contact), jnp.float32(jc.gravity),
        jnp.float32(jc.restitution))
    g_t = _torch_grads(pos, vel, wp, wv, tc, _diff(tc))
    return (pos, vel, wp, wv, tc), [np.asarray(g) for g in g_j], g_t


def test_grads_match_jax(hot_grads):
    _, g_j, g_t = hot_grads
    for name, a, b in zip(NAMES, g_t, g_j):
        assert np.isfinite(a).all(), name
        assert np.abs(a).max() > 0.0, name           # gradients flow
        assert _rel(a, b) < 1e-4, name


def test_grads_match_dense_mirror(hot_grads):
    (pos, vel, wp, wv, tc), _, g_t = hot_grads
    g_d = _torch_grads(pos, vel, wp, wv, tc, _dense(tc))
    for name, a, b in zip(NAMES, g_t, g_d):
        assert _rel(a, b) < 1e-4, name


def test_grads_finite_with_walls_and_rejects_window_mode(setup):
    pos, vel, wp, wv = setup
    _, tc = _cfgs()
    hot = (vel * np.float32(8.0)).astype(np.float32)
    g = _torch_grads(pos, hot, wp, wv, tc, _diff(tc))
    assert all(np.isfinite(a).all() for a in g)
    s = ParticleState(pos=torch.tensor(pos), vel=torch.tensor(vel))
    with pytest.raises(ValueError, match="CIV"):
        tgr.multi_step_diff(s, dataclasses.replace(tc, civ=False), DT, 2)
    with pytest.raises(ValueError, match="CIV"):
        tgr.multi_step_diff(s, dataclasses.replace(tc, bounds=0.1), DT, 2)


def test_dispatch_counts_no_launch_on_cpu(setup):
    """CPU tensors take the plain versions and launch nothing; other
    devices raise; the kernels refuse CPU tensors."""
    pos, _, _, _ = setup
    _, tc = _cfgs()
    tpos = torch.tensor(pos)
    grid, slabs, _ = tgr.rebuild(tpos, torch.zeros_like(tpos), tc)
    before = (gk.LAUNCHES_FORCES, gk.LAUNCHES_JVP)
    gk.contact_force_jvp_sorted(grid.sorted_pos, grid.sorted_pos, 0.1, 2000.0,
                                slabs)
    gk.contact_forces_sorted(grid.sorted_pos, 0.1, 2000.0, slabs)
    assert (gk.LAUNCHES_FORCES, gk.LAUNCHES_JVP) == before
    meta = grid.sorted_pos.to("meta")
    with pytest.raises(ValueError):
        gk.contact_forces_sorted(meta, 0.1, 2000.0, slabs)
    with pytest.raises(ValueError):
        gk.contact_force_jvp_sorted(meta, meta, 0.1, 2000.0, slabs)
    with pytest.raises(ValueError, match="CUDA"):
        gk.contact_forces_sorted_kernel(grid.sorted_pos, 0.1, 2000.0, slabs)
    with pytest.raises(ValueError, match="CUDA"):
        gk.contact_force_jvp_sorted_kernel(grid.sorted_pos, grid.sorted_pos,
                                           0.1, 2000.0, slabs)


def test_inverse_granular_objective_falls():
    """``examples/inverse_granular.py`` on the CPU: the problem is the JAX
    example's; the loss at the truth is ~0, and a few Adam iterations from
    the example's start bring it down."""
    from wgpu_physics_engine_torch.examples import inverse_granular as ig

    config, state, target, true, n_steps = ig.make_problem(device="cpu")
    assert config == tgr.GranularConfig(**BASE)
    theta_true = torch.tensor([float(np.log(np.float32(config.k_contact))),
                               0.1 * config.gravity, config.restitution])
    assert float(ig.objective(theta_true, config, state, target,
                              n_steps)) < 1e-8
    losses = []
    ig.fit(config, state, target, true, n_steps, n_iters=6, verbose=False,
           losses=losses)
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < 0.8 * losses[0]
