"""Port parity, the grain-sharded granular pile: ``parallel/granular_mesh.py``
of the port on CPU shards (its shards step through K10b's plain version)
against the port's single-device path and the JAX package's XLA route.

The tests mirror ``tests/test_granular_mesh.py`` at its sizes. Inputs come
from the JAX package's ``init_state`` (or a numpy seed) through numpy.
Tolerances, with their reasons:

* one rebuild block with the sharded pad equal to the single-device one
  (N = 2048 on 2 shards): bit for bit against the port's
  ``granular.multi_step`` (the same rebuild, the same per-particle sums);
* several blocks on 4 shards against JAX's ``backend="xla"``: pos 1e-4,
  vel 1e-3 and nothing dropped, the JAX test's own contract (the same
  candidate sets, sums in another order);
* ``multi_step_diff_sharded`` against the per-world serial sum of the
  port's ``multi_step_diff``: the value to 1e-6 and each gradient to 1e-5
  relative, the JAX test's contract (the shards run the same per-world
  programs; only autograd's sum of the scalars' cotangents differs in
  order); its value against JAX's XLA route on the same worlds within
  the contact contract (pos 1e-4, vel 1e-3) summed under the loss
  weights (the forward is the frozen contact schedule of both packages;
  JAX's ``multi_step_diff`` itself needs its Pallas kernels, which only
  run in interpret mode here);
* K10b's plain version on a slice of the sorted slots against the same
  rows of a full substep: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core.state import ParticleState as JState
from wgpu_physics_engine_tpu.models import granular as jgr
from wgpu_physics_engine_torch.core.state import (ParticleState,
                                                  particle_state_from_numpy)
from wgpu_physics_engine_torch.models import granular as tgr
from wgpu_physics_engine_torch.ops import granular_kernel as gk
from wgpu_physics_engine_torch.parallel import granular_mesh
from wgpu_physics_engine_torch.parallel import mesh as pmesh

DT = 1.0 / 240.0
PILE = dict(bounds=2.0, radius=0.08, restitution=0.4, rebuild_every=4,
            pallas_block=128, pallas_slab=384)


def _cfgs(n, **kw):
    return (jgr.GranularConfig(num_particles=n, **PILE, **kw),
            tgr.GranularConfig(num_particles=n, **PILE, **kw))


def _mesh(n, axis="grains"):
    return pmesh.make_mesh((n,), (axis,), ["cpu"] * n)


def test_sharded_matches_single_one_rebuild():
    """One frozen block (n_steps == rebuild_every), N chosen so the sharded
    pad (block·8·D) equals the single-device pad: every shard's launch
    sees the operands of the single-device launch, so the result is
    bitwise equal to the port's single-device kernel route."""
    jc, tc = _cfgs(2048)
    assert tgr.pad_slots(2048, tc, unit=128 * 8 * 2) == tgr.pad_slots(2048,
                                                                      tc)
    state = particle_state_from_numpy(jgr.init_state(jc, jax.random.key(0)),
                                      device="cpu")
    out_s = granular_mesh.multi_step_sharded(state, tc, DT, 4, _mesh(2))
    out_1 = tgr.multi_step(state, tc, DT, 4)
    assert torch.equal(out_s.pos, out_1.pos)
    assert torch.equal(out_s.vel, out_1.vel)


def test_sharded_matches_xla_multi_rebuild():
    """Two rebuilds and a remainder block on 4 shards (two of which own no
    slot: the pad is 4096) against JAX's XLA frozen path."""
    jc, tc = _cfgs(2048)
    js = jgr.init_state(jc, jax.random.key(1))
    out_s, dmax = granular_mesh.multi_step_sharded(
        particle_state_from_numpy(js, device="cpu"), tc, DT, 10, _mesh(4),
        return_stats=True)
    out_x = jgr.multi_step(js, jc, jnp.float32(DT), 10, backend="xla")
    assert int(dmax) == 0
    np.testing.assert_allclose(out_s.pos.numpy(), np.asarray(out_x.pos),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(out_s.vel.numpy(), np.asarray(out_x.vel),
                               atol=1e-3, rtol=0)


def test_diff_sharded_gradients_match_serial():
    """Worlds-DP differentiable path on 2 shards: the gradients of a summed
    loss over the sharded worlds equal the sums of per-world serial
    gradients (state cotangents shard-local, scalar cotangents summed back
    over the shards' copies), and the value is JAX's."""
    jc, tc = _cfgs(256, grid_capacity=16)
    n_worlds, n_steps = 2, 5          # one rebuild segment and a remainder
    rng = np.random.default_rng(0)
    worlds = []
    for i in range(n_worlds):
        s = tgr.multi_step(particle_state_from_numpy(
            jgr.init_state(jc, jax.random.key(i)), device="cpu"), tc, DT, 30)
        worlds.append((s.pos.numpy(), (8.0 * s.vel).numpy()))   # hot
    pos = np.stack([w[0] for w in worlds])
    vel = np.stack([w[1] for w in worlds])
    wp = rng.standard_normal(pos.shape).astype(np.float32)
    wv = rng.standard_normal(vel.shape).astype(np.float32)

    def leaves():
        return [torch.tensor(v, dtype=torch.float32, requires_grad=True)
                for v in (DT, tc.k_contact, tc.gravity, tc.restitution)]

    sc = leaves()
    out = granular_mesh.multi_step_diff_sharded(
        ParticleState(pos=torch.tensor(pos), vel=torch.tensor(vel)), tc,
        sc[0], n_steps, _mesh(2, "worlds"), k_contact=sc[1], gravity=sc[2],
        restitution=sc[3])
    v1 = (out.pos * torch.tensor(wp)).sum() + (out.vel * torch.tensor(wv)).sum()
    g1 = torch.autograd.grad(v1, sc)

    sc2 = leaves()
    v2 = 0.0
    for i in range(n_worlds):
        o = tgr.multi_step_diff(
            ParticleState(pos=torch.tensor(pos[i]), vel=torch.tensor(vel[i])),
            tc, sc2[0], n_steps, k_contact=sc2[1], gravity=sc2[2],
            restitution=sc2[3])
        v2 = v2 + ((o.pos * torch.tensor(wp[i])).sum()
                   + (o.vel * torch.tensor(wv[i])).sum())
    g2 = torch.autograd.grad(v2, sc2)
    v1, v2 = float(v1.detach()), float(v2.detach())
    np.testing.assert_allclose(v1, v2, rtol=1e-6)
    for name, a, b in zip(("dt", "kc", "grav", "e"), g1, g2):
        a, b = float(a), float(b)
        assert abs(a - b) / max(abs(b), 1e-30) < 1e-5, name
        assert abs(a) > 0.0, name

    vj = 0.0
    for i in range(n_worlds):
        o = jgr.multi_step(JState(pos=jnp.asarray(pos[i]),
                                  vel=jnp.asarray(vel[i])), jc,
                           jnp.float32(DT), n_steps, backend="xla")
        vj += float(np.sum(np.asarray(o.pos, np.float64) * wp[i])
                    + np.sum(np.asarray(o.vel, np.float64) * wv[i]))
    # the contact contract, pos 1e-4 and vel 1e-3, summed under the weights
    bound = float(1e-4 * np.abs(wp).sum() + 1e-3 * np.abs(wv).sum())
    assert abs(v1 - vj) <= bound, (v1, vj, bound)


def test_sharded_rejects_bad_shapes():
    jc, tc = _cfgs(1026)                           # not divisible by 4
    state = particle_state_from_numpy(jgr.init_state(jc, jax.random.key(2)),
                                      device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        granular_mesh.multi_step_sharded(state, tc, 1e-3, 4, _mesh(4))
    tc2 = tgr.GranularConfig(num_particles=2048, bounds=2.0, radius=0.08,
                             rebuild_every=4, civ=False)
    state2 = tgr.init_state(tc2, torch.Generator().manual_seed(2),
                            device="cpu")
    with pytest.raises(ValueError, match="CIV"):
        granular_mesh.multi_step_sharded(state2, tc2, 1e-3, 4, _mesh(4))
    with pytest.raises(ValueError, match="worlds not divisible"):
        granular_mesh.multi_step_diff_sharded(
            ParticleState(pos=state2.pos[None].expand(3, 3, 2048),
                          vel=state2.vel[None].expand(3, 3, 2048)),
            tc2, 1e-3, 1, _mesh(2, "worlds"))


@pytest.mark.parametrize("base,n_local", [(0, 512), (512, 1024),
                                          (1536, 512), (0, 2048)])
def test_k10b_plain_slice_matches_full_substep(base, n_local):
    """K10b's plain version on the sorted slots [base, base + n_local) of a
    dense pile ≡ the same rows of the full substep, bit for bit; a slice
    that does not start on a block, or a base without its count, raises."""
    _, tc = _cfgs(2048)
    rng = np.random.default_rng(6)
    pos = torch.tensor(rng.uniform(-1.0, 1.0, (3, 2048)).astype(np.float32))
    vel = torch.tensor(rng.standard_normal((3, 2048)).astype(np.float32))
    grid, slabs, dropped = tgr.rebuild(pos, vel, tc, stats=True)
    prm = gk.kernel_params(tc, DT, "cpu")
    p, v = grid.sorted_pos, grid.sorted_vel
    full_p, full_v = gk.substep_sorted(p, v, prm, slabs)
    sp, sv = gk.substep_sorted(p, v[:, base:base + n_local], prm, slabs,
                               base=base, n_local=n_local)
    assert int(dropped) == 0
    assert gk.touching_count(p, prm, slabs) > 0
    assert torch.equal(sp, full_p[:, base:base + n_local])
    assert torch.equal(sv, full_v[:, base:base + n_local])
    with pytest.raises(ValueError, match="start on a block"):
        gk.substep_sorted(p, v[:, :64], prm, slabs, base=64, n_local=64)
    with pytest.raises(ValueError, match="needs its local count"):
        gk.substep_sorted(p, v, prm, slabs, base=128)
    with pytest.raises(ValueError, match="multiple of the block"):
        tgr.rebuild(pos, vel, tc, n_pad=2048 + 64)
