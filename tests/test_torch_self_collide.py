"""Port parity, cloth self-collision: the plain version of K1f
(``cloth_kernel.substep_with_force``), ``models.cloth.
multi_step_self_collide`` (both schedules, both spring paths) and
``multi_step_self_collide_diff`` against the JAX package on the CPU (its
Pallas kernels in interpret mode). Then, on the port alone, K1f's sorted
entry (``cloth_kernel.substep_with_force_sorted``) against the gather,
plain substep and scatter it replaces, and the frozen block on it against
the per-substep gathers around K11 and K1f, bit for bit, with the
parameters packed once a block.

The configuration is ``tests/test_self_collide_grad.py``'s: a 12×12 cloth
of side 2 and particle radius 0.12 (neighbours overlap, so self-contacts
are active from the start) at y = 40, stepped 40 substeps by the JAX
package and handed to the port as numpy arrays, a skin-sized grid of
capacity 32, rebuild every 4, block 128, slab 384. The cloth stays far
above the globe, so no particle sits on the globe-contact knife edge that
makes XLA's FMA contraction and the port's two roundings take different
branches (``tests/test_torch_grad.py``). Tolerances, with their reasons:

* one substep: 1e-6 (``tests/test_cloth_vs_oracle.py:62-71``);
* several substeps through contact: positions 1e-5, velocities 1e-4, the
  contact-path contract (``tests/test_granular_pallas.py:51-54``), with
  equal dropped counts;
* gradients: 1e-4 max-relative (``tests/test_self_collide_grad.py:145``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.core.state import ClothParams as JParams
from wgpu_physics_engine_tpu.core.state import init_cloth_state as jinit
from wgpu_physics_engine_tpu.models import cloth as jcloth
from wgpu_physics_engine_tpu.ops import cloth_pallas
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                  params_from_numpy,
                                                  state_from_numpy)
from wgpu_physics_engine_torch.models import cloth as tcloth
from wgpu_physics_engine_torch.ops import cloth_kernel, granular_kernel

DT = 1.0 / 480.0
N_STEPS = 6            # rebuild_every=4: one full block and a remainder
REBUILD = 4
BLOCK, SLAB = 128, 384
CLOTH = dict(height=12, width=12, cloth_size=2.0, center=(0.0, 40.0, 0.0),
             particle_radius=0.12)


def _rel(a, b, floor=1e-30) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), floor))


@pytest.fixture(scope="module")
def setup():
    jc = jcfg.ClothConfig(**CLOTH)
    jp = JParams.from_config(jc)
    js = jcloth.multi_step(jinit(jc), jp, jnp.float32(DT), 40)
    jgrid = dataclasses.replace(
        jcloth.default_self_collision_grid(jc, skin=2 * jc.particle_radius),
        capacity=32)
    tc = tcfg.ClothConfig(**CLOTH)
    tgrid = dataclasses.replace(
        tcloth.default_self_collision_grid(tc, skin=2 * tc.particle_radius),
        capacity=32)
    assert dataclasses.astuple(tgrid) == dataclasses.astuple(jgrid)
    rng = np.random.default_rng(3)
    wp, wv = (rng.standard_normal((3, 12, 12)).astype(np.float32)
              for _ in range(2))
    return dict(js=js, jp=jp, jgrid=jgrid,
                ts=state_from_numpy(js, device="cpu"),
                tp=params_from_numpy(jp, device="cpu"), tgrid=tgrid, wp=wp,
                wv=wv)


def _close(t, j, pos_tol, vel_tol):
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), atol=pos_tol,
                               rtol=0)
    np.testing.assert_allclose(t.vel.numpy(), np.asarray(j.vel), atol=vel_tol,
                               rtol=0)


@pytest.mark.parametrize("pins", [False, True], ids=["free", "pinned"])
def test_substep_with_force_plain_matches_jax(setup, pins):
    """K1f's plain version against JAX's ``substep_with_force`` (interpret
    mode): one substep, 1e-6; with ``fext = 0`` it equals K1's plain
    version bit for bit."""
    js, ts, jp, tp = setup["js"], setup["ts"], setup["jp"], setup["tp"]
    if pins:
        mask = np.zeros((12, 12), bool)
        mask[0] = True
        js = js._replace(pin_mask=jnp.asarray(mask), pin_pos=js.pos)
        ts = state_from_numpy(js, device="cpu")
    fext = (50.0 * np.random.default_rng(9).standard_normal(
        (3, 12, 12))).astype(np.float32)
    ref = cloth_pallas.substep_with_force(js, jp, jnp.float32(DT),
                                          jnp.asarray(fext), interpret=True)
    got = cloth_kernel.substep_with_force(ts, tp, DT, torch.tensor(fext))
    _close(got, ref, 1e-6, 1e-6)
    assert float((got.pos - ts.pos).abs().max()) > 0
    zero = cloth_kernel.substep_with_force(ts, tp, DT, torch.zeros(3, 12, 12))
    k1 = cloth_kernel.multi_step_plain(ts, tp, DT, 1)
    assert torch.equal(zero.pos, k1.pos) and torch.equal(zero.vel, k1.vel)
    assert cloth_kernel.LAUNCHES_FORCE == 0


@pytest.mark.parametrize("rebuild,kernel,n_steps", [
    (1, True, N_STEPS), (1, False, N_STEPS), (REBUILD, True, N_STEPS),
    (REBUILD, False, N_STEPS), (REBUILD, True, 1)],
    ids=["exact-kernel", "exact-stencil", "frozen-kernel", "frozen-stencil",
         "frozen-1-substep"])
def test_multi_step_self_collide_matches_jax(setup, rebuild, kernel, n_steps):
    """The exact schedule (rebuild every substep) and the frozen one (K11
    on the thin candidate set, then K1f or the stencil springs) against
    JAX, with equal dropped counts; one substep at 1e-6."""
    s = setup
    ref, jd = jcloth.multi_step_self_collide(
        s["js"], s["jp"], jnp.float32(DT), n_steps, s["jgrid"],
        rebuild_every=rebuild, pallas_block=BLOCK, pallas_slab=SLAB,
        interpret=True, return_stats=True, use_spring_kernel=kernel)
    got, td = tcloth.multi_step_self_collide(
        s["ts"], s["tp"], DT, n_steps, s["tgrid"], rebuild_every=rebuild,
        pallas_block=BLOCK, pallas_slab=SLAB, return_stats=True,
        use_spring_kernel=kernel)
    assert int(td) == int(jd) == 0
    if n_steps == 1:
        _close(got, ref, 1e-6, 1e-6)
    else:
        _close(got, ref, 1e-5, 1e-4)
    # self-contact is active: the run differs from the cloth without it
    free = cloth_kernel.multi_step_plain(s["ts"], s["tp"], DT, n_steps)
    assert float((got.vel - free.vel).abs().max()) > 1e-3


def test_diff_primal_matches_production(setup):
    """The differentiable path runs the production path's operations
    (K11, stencil springs, integrate) in the same order."""
    s = setup
    prod = tcloth.multi_step_self_collide(
        s["ts"], s["tp"], DT, N_STEPS, s["tgrid"], rebuild_every=REBUILD,
        pallas_block=BLOCK, pallas_slab=SLAB, use_spring_kernel=False)
    diff = tcloth.multi_step_self_collide_diff(
        s["ts"], s["tp"], DT, N_STEPS, s["tgrid"], rebuild_every=REBUILD,
        pallas_block=BLOCK, pallas_slab=SLAB)
    np.testing.assert_allclose(diff.pos.numpy(), prod.pos.numpy(), atol=1e-7,
                               rtol=0)
    np.testing.assert_allclose(diff.vel.numpy(), prod.vel.numpy(), atol=1e-6,
                               rtol=0)


def test_diff_grads_match_jax(setup):
    """Gradients of a fixed linear loss with respect to pos, vel, dt and
    every ``ClothParams`` leaf (``k_contact`` and ``particle_radius``
    through the contact kernel's identities) against JAX's
    ``multi_step_self_collide_diff``."""
    s = setup
    wp, wv = s["wp"], s["wv"]

    def jloss(pos, vel, dt, p):
        out = jcloth.multi_step_self_collide_diff(
            s["js"]._replace(pos=pos, vel=vel), p, dt, N_STEPS, s["jgrid"],
            rebuild_every=REBUILD, pallas_block=BLOCK, pallas_slab=SLAB,
            interpret=True)
        return jnp.sum(out.pos * wp) + jnp.sum(out.vel * wv)

    g_j = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        s["js"].pos, s["js"].vel, jnp.float32(DT), s["jp"])
    pos = s["ts"].pos.clone().requires_grad_()
    vel = s["ts"].vel.clone().requires_grad_()
    dt = torch.tensor(DT, dtype=torch.float32, requires_grad=True)
    leaves = [a.clone().requires_grad_() for a in s["tp"]]
    out = tcloth.multi_step_self_collide_diff(
        s["ts"]._replace(pos=pos, vel=vel), ClothParams(*leaves), dt,
        N_STEPS, s["tgrid"], rebuild_every=REBUILD, pallas_block=BLOCK,
        pallas_slab=SLAB)
    loss = (out.pos * torch.tensor(wp)).sum() + (out.vel * torch.tensor(wv)).sum()
    g_t = torch.autograd.grad(loss, [pos, vel, dt] + leaves)
    want = [g_j[0], g_j[1], g_j[2]] + [getattr(g_j[3], f)
                                       for f in ClothParams._fields]
    names = ["pos", "vel", "dt"] + list(ClothParams._fields)
    for name, a, b in zip(names, g_t, want):
        a = a.numpy()
        assert np.isfinite(a).all(), name
        assert _rel(a, b, floor=1e-6) < 1e-4, name
    for name in ("pos", "vel", "dt", "k_contact", "particle_radius",
                 "k_struct"):
        assert np.abs(g_t[names.index(name)].numpy()).max() > 0.0, name


def test_diff_grads_with_pins(setup):
    """Pins: the gradients stay finite and reach the pin targets (the
    pinned particles' output is their target)."""
    s = setup
    mask = torch.zeros((12, 12), dtype=torch.bool)
    mask[0, :3] = True
    pos = s["ts"].pos.clone().requires_grad_()
    pin_pos = s["ts"].pos.clone().requires_grad_()
    st = s["ts"]._replace(pos=pos, pin_mask=mask, pin_pos=pin_pos)
    out = tcloth.multi_step_self_collide_diff(
        st, s["tp"], DT, N_STEPS, s["tgrid"], rebuild_every=REBUILD,
        pallas_block=BLOCK, pallas_slab=SLAB)
    loss = (out.pos * torch.tensor(s["wp"])).sum()
    gp, gq = torch.autograd.grad(loss, [pos, pin_pos])
    assert torch.isfinite(gp).all() and torch.isfinite(gq).all()
    assert float(gq[:, mask].abs().max()) > 0.0
    assert float(gq[:, ~mask].abs().max()) == 0.0


def test_self_collision_forces_match_jax(setup):
    """The exact schedule's broad phase and narrow phase on their own."""
    s = setup
    ref = jcloth.self_collision_forces(s["js"].pos, s["js"].vel, s["jp"],
                                       s["jgrid"])
    got = tcloth.self_collision_forces(s["ts"].pos, s["ts"].vel, s["tp"],
                                       s["tgrid"])
    assert float(got.abs().max()) > 1.0
    assert _rel(got.numpy(), ref) <= 1e-5
    assert granular_kernel.LAUNCHES_FORCES == 0


# --- K1f's sorted entry and the frozen block (port only, no JAX run) ---

def _pinned_state(ts):
    mask = torch.zeros((12, 12), dtype=torch.bool)
    mask[0] = True
    return ts._replace(pin_mask=mask, pin_pos=ts.pos)


def _frozen(setup, ts):
    """The block's rebuild on ``ts``: the grid and thin slabs, the inverse
    permutation and the pair forces in sorted order (K11's plain version)."""
    grid, slabs, _ = tcloth._frozen_structs(
        ts.pos.reshape(3, -1), ts.vel.reshape(3, -1), setup["tgrid"], BLOCK,
        SLAB)
    md = 2.0 * setup["tp"].particle_radius
    f = granular_kernel.contact_forces_sorted(grid.sorted_pos, md,
                                              setup["tp"].k_contact, slabs)
    return grid, slabs, f


@pytest.mark.parametrize("pins", [False, True], ids=["free", "pinned"])
def test_sorted_entry_plain_is_gather_substep_scatter(setup, pins):
    """The sorted entry's plain version equals, bit for bit, the gather of
    the sorted forces to the grid, ``substep_with_force_plain`` and the
    scatter of the new positions to the sorted order (``pos[:, order]``);
    without ``want_sp`` it writes no sorted copy."""
    ts = _pinned_state(setup["ts"]) if pins else setup["ts"]
    grid, _, f = _frozen(setup, ts)
    inv = tcloth.broadphase._inverse(grid.order)
    blk, st = cloth_kernel.force_block(ts, setup["tp"], DT, inv)
    got, sp = cloth_kernel.substep_with_force_sorted(st, blk, f)
    ref = cloth_kernel.substep_with_force_plain(
        ts, setup["tp"], DT, f[:, inv].reshape(3, 12, 12))
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    assert torch.equal(sp, ref.pos.reshape(3, -1)[:, grid.order.long()])
    assert float((got.pos - ts.pos).abs().max()) > 0
    last, none = cloth_kernel.substep_with_force_sorted(st, blk, f,
                                                        want_sp=False)
    assert none is None and torch.equal(last.pos, got.pos)
    assert cloth_kernel.LAUNCHES_FORCE == 0


def _parent_block(setup, ts, length):
    """The frozen block as it was composed before the sorted entry: every
    substep the positions gathered to the sorted order, K11, the forces
    gathered back to the grid, then ``substep_with_force``."""
    grid, slabs, _ = _frozen(setup, ts)
    order = grid.order.long()
    inv = tcloth.broadphase._inverse(grid.order)
    md = 2.0 * setup["tp"].particle_radius
    for _ in range(length):
        sp = ts.pos.reshape(3, -1)[:, order]
        f = granular_kernel.contact_forces_sorted(
            sp, md, setup["tp"].k_contact, slabs)[:, inv].reshape(3, 12, 12)
        ts = cloth_kernel.substep_with_force(ts, setup["tp"], DT, f)
    return ts


@pytest.mark.parametrize("pins", [False, True], ids=["free", "pinned"])
def test_self_collide_block_equals_parent_composition(setup, pins):
    """``_self_collide_block`` on the sorted entry equals the parent's
    per-substep gathers around K11 and K1f bit for bit over a block of
    ``REBUILD`` substeps."""
    ts = _pinned_state(setup["ts"]) if pins else setup["ts"]
    got, dropped = tcloth._self_collide_block(
        ts, setup["tp"], torch.tensor(DT), REBUILD, setup["tgrid"], BLOCK,
        SLAB)
    ref = _parent_block(setup, ts, REBUILD)
    assert int(dropped) == 0
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    assert float((got.pos - ts.pos).abs().max()) > 0


def test_self_collide_block_packs_params_once(setup, monkeypatch):
    """The block packs the cloth parameters once, not once a substep."""
    calls = []
    pack = cloth_kernel._pack_params

    def counted(p, dt):
        calls.append(1)
        return pack(p, dt)

    monkeypatch.setattr(cloth_kernel, "_pack_params", counted)
    tcloth._self_collide_block(setup["ts"], setup["tp"], torch.tensor(DT),
                               REBUILD, setup["tgrid"], BLOCK, SLAB)
    assert len(calls) == 1
