"""Port parity, the distributed training example and the differentiable
rows path: ``wgpu_physics_engine_torch/examples/multichip_training.py``,
``ops.cloth_grad_kernel.multi_step_window`` (the window's autograd
Function), its window adjoint's plain version and ``cloth_kernel.
trace_window``, on CPU shards, against the JAX package and against the
port's own references.

Tolerances, with their reasons:

* the example's gradient d loss/d log k at k = 430, the truth and 470
  against ``jax.value_and_grad`` of JAX's loss on JAX's own problem (its
  ``PRNGKey(7)`` noise, carried across as numpy): within 1e-5 of the
  largest |g| of the three, and the losses within 1e-5 relative away from
  the truth. JAX's path is XLA autodiff of its window stencil, which
  contracts ``a*b + c`` into FMA on the CPU where the port rounds twice;
  the measured gap is 4.6e-7 of a largest |g| of 0.568 (8.1e-7);
* the window adjoint's plain version against ``torch.autograd`` of
  ``multi_step_window_plain``: 1e-5 max-relative, ``tests/
  test_torch_grad.py``'s for the whole-grid adjoint (the same expressions
  in another order); the dead rows' parameter terms exactly 0;
* the sharded gradient against ``cloth_grad_kernel.multi_step`` on the
  whole grid: within 1e-5 of max|g|, since the forward is the same bits and
  only the order of the cotangent sums differs; against autograd of the
  stencil shard body (``use_kernel=False``, another formulation of the
  forward, ``tests/test_torch_parallel.py``'s 1e-5 on pos): 1e-4;
* the learning-rate schedule against ``optax.exponential_decay(0.05, 12,
  0.7)``: 1e-6 relative (float32 against float64 powers).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.core import state as tstate
from wgpu_physics_engine_torch.examples import multichip_training as mt
from wgpu_physics_engine_torch.ops import cloth_grad_kernel as cg
from wgpu_physics_engine_torch.ops import cloth_kernel
from wgpu_physics_engine_torch.parallel import mesh as pmesh

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
KS = (430.0, None, 470.0)                 # None: the true k_struct


def _max_rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)


def _value_and_grads(state, params, m, target, ks):
    """The port's loss and d loss/d log k at each k of ``ks``."""
    out = []
    for k in ks:
        log_k = torch.log(torch.tensor(k, dtype=torch.float32)
                          ).requires_grad_(True)
        loss = mt.loss_fn(log_k, state, params, m, target)
        (g,) = torch.autograd.grad(loss, log_k)
        out.append((float(loss.detach()), float(g)))
    return out


@pytest.fixture(scope="module")
def port_brackets():
    """The port's example on its own problem (8 CPU shards, a (4, 2)
    worlds × rows mesh): the three (loss, gradient) pairs."""
    m, _, params, state = mt.make_problem(device="cpu")
    assert m.shape == {"worlds": 4, "rows": 2}
    with torch.no_grad():
        target = mt.rollout(state, params, m)
    ks = [float(params.k_struct) if k is None else k for k in KS]
    return _value_and_grads(state, params, m, target, ks)


@pytest.fixture(scope="module")
def jax_and_port():
    """JAX's example (loaded by path) on the conftest's 8 virtual devices
    and the port on 8 CPU shards, both on JAX's problem: the three (loss,
    gradient) pairs of each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(ROOT)
        spec = importlib.util.spec_from_file_location(
            "_jax_multichip_training",
            os.path.join(ROOT, "examples", "multichip_training.py"))
        jmt = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jmt)
        m, _, params, state = jmt.make_problem()
        target = jmt.rollout(state, params, m)

        def loss(log_k):
            out = jmt.rollout(state, params._replace(k_struct=jnp.exp(log_k)),
                              m)
            return 1e3 * jnp.mean((out.pos - target.pos) ** 2)

        vg = jax.jit(jax.value_and_grad(loss))
        ks = [float(params.k_struct) if k is None else k for k in KS]
        ref = [tuple(float(x) for x in vg(jnp.log(jnp.float32(k))))
               for k in ks]
    tp = tstate.params_from_numpy(params, device="cpu")
    ts = tstate.ClothState(pos=torch.tensor(np.asarray(state.pos)),
                           vel=torch.tensor(np.asarray(state.vel)))
    tm = pmesh.make_mesh((4, 2), ("worlds", "rows"), ["cpu"] * 8)
    with torch.no_grad():
        tt = mt.rollout(ts, tp, tm)
    np.testing.assert_allclose(tt.pos.numpy(), np.asarray(target.pos),
                               atol=1e-5)
    return ref, _value_and_grads(ts, tp, tm, tt, ks)


def test_example_gradient_brackets_truth(port_brackets):
    """``tests/test_examples.py``'s assertions on the port's example: the
    gradients from both sides point at the true stiffness, the loss and
    gradient vanish there."""
    (l_lo, g_lo), (l_at, g_at), (l_hi, g_hi) = port_brackets
    assert g_lo < 0 < g_hi
    assert l_at < 1e-8 and abs(g_at) < 1e-4
    assert l_lo > 1e-4 and l_hi > 1e-4


@pytest.mark.parametrize("i", range(len(KS)))
def test_example_gradient_matches_jax(jax_and_port, i):
    ref, got = jax_and_port
    g_max = max(abs(g) for _, g in ref)
    assert abs(got[i][1] - ref[i][1]) <= 1e-5 * g_max
    if KS[i] is None:
        assert got[i][0] < 1e-8 and ref[i][0] < 1e-8
    else:
        assert abs(got[i][0] - ref[i][0]) <= 1e-5 * ref[i][0]


def test_example_main_takes_a_step_toward_the_truth(capsys):
    k, k_true = mt.main(n_iters=1, n_devices=8, device="cpu")
    assert "recovered k_struct" in capsys.readouterr().out
    # Adam's first step moves log k by the learning rate, toward the truth
    np.testing.assert_allclose(np.log(k / (0.5 * k_true)), mt.LR, rtol=1e-3)


def test_learning_rate_schedule_matches_optax():
    log_k = torch.zeros((), requires_grad=True)
    opt, sched = mt.make_optimizer(log_k)
    ref = optax.exponential_decay(0.05, 12, 0.7)
    for t in range(61):
        lr = opt.param_groups[0]["lr"]
        np.testing.assert_allclose(lr, float(ref(t)), rtol=1e-6)
        log_k.grad = torch.ones(())
        opt.step()
        sched.step()


# ---------------------------------------------------------------------------
# The window adjoint's plain version against torch.autograd
# ---------------------------------------------------------------------------

H_GLOBAL, W = 24, 10


def _window_of(x, lo, hi, h):
    """Rows [lo, hi) of ``x`` [..., h, W], zero beyond the grid (a boundary
    shard's halo)."""
    out = torch.zeros(x.shape[:-2] + (hi - lo, x.shape[-1]), dtype=x.dtype)
    a, b = max(lo, 0), min(hi, h)
    out[..., a - lo:b - lo, :] = x[..., a:b, :]
    return out


def _contact_grid(pins):
    """A small cloth on top of the globe, a patch of it inside the contact
    distance, with random velocities (contact, friction and projection
    run), and with ``pins`` every other particle of every sixth row
    pinned (each window holds some)."""
    c = tcfg.ClothConfig(height=H_GLOBAL, width=W, cloth_size=3.0,
                         center=(0.0, 10.05, 0.0))
    s = tstate.init_cloth_state(c, device="cpu")
    rng = np.random.default_rng(4)
    s = s._replace(
        pos=s.pos + torch.tensor(0.01 * rng.standard_normal(
            (3, H_GLOBAL, W)), dtype=torch.float32),
        vel=torch.tensor(rng.standard_normal((3, H_GLOBAL, W)),
                         dtype=torch.float32))
    if pins:
        mask = torch.zeros((H_GLOBAL, W), dtype=torch.bool)
        mask[::6, ::2] = True
        s = s._replace(pin_mask=mask, pin_pos=s.pos.clone())
    prm = cloth_kernel._pack_params(
        tstate.ClothParams.from_config(c, device="cpu"), mt.DT)
    return s, prm


# (row0, rows): the top window (4 dead rows above the grid), a middle one
# and the bottom one (4 dead rows below)
WINDOWS = {"top": (-4, 16), "middle": (4, 16), "bottom": (12, 16)}


@pytest.mark.parametrize("pins", [False, True])
@pytest.mark.parametrize("where", list(WINDOWS))
def test_window_adjoint_plain_matches_autograd(where, pins):
    """``walk_window``'s plain version over the trace of two substeps (and
    ``substep_vjp_window_plain`` for one) against ``torch.autograd`` of
    ``multi_step_window_plain`` on the same window: the cotangents of pos,
    vel, pin_pos and the packed parameters. The parameter cotangent is
    finite, and the dead rows add exactly 0 to it."""
    row0, rows = WINDOWS[where]
    s, prm = _contact_grid(pins)
    win = [None if a is None else _window_of(a, row0, row0 + rows, H_GLOBAL)
           for a in (s.pos, s.vel, s.pin_mask, s.pin_pos)]
    dist = torch.linalg.vector_norm(win[0], dim=0)
    assert bool((dist < prm[14]).any())               # contact runs
    rng = np.random.default_rng(7)
    wp, wv = (torch.tensor(rng.standard_normal((3, rows, W)),
                           dtype=torch.float32) for _ in range(2))
    pins_t = None if not pins else (win[2], win[3])
    for n in (1, 2):
        leaves = [win[0].clone().requires_grad_(True),
                  win[1].clone().requires_grad_(True),
                  None if not pins else win[3].clone().requires_grad_(True),
                  prm.clone().requires_grad_(True)]
        p, v = cloth_kernel._window_plain_packed(
            leaves[0], leaves[1], win[2], leaves[2], leaves[3], n, row0,
            H_GLOBAL)
        want = [x for x in leaves if x is not None]
        ref = torch.autograd.grad((p * wp).sum() + (v * wv).sum(), want)
        traj = cloth_kernel.trace_window(win[0], win[1], win[2], win[3], prm,
                                         n, row0, H_GLOBAL)
        got = cg.walk_window(traj, wp, wv, prm, row0, H_GLOBAL, pins_t)
        if n == 1:
            one = cg.substep_vjp_window_plain(traj[0], wp, wv, prm, row0,
                                              H_GLOBAL, pins_t)
            for a, b in zip(one, got):
                assert (a is None and b is None) or torch.equal(a, b)
        assert _max_rel(got[0], ref[0]) < 1e-5
        assert _max_rel(got[1], ref[1]) < 1e-5
        assert _max_rel(got[2], ref[-1]) < 1e-5
        assert bool(torch.isfinite(got[2]).all())
        if pins:
            assert _max_rel(got[3], ref[2]) < 1e-5
            assert float(got[3].abs().max()) > 0
        else:
            assert got[3] is None
    # with the rows path's cotangent (0 on the dead rows, which no spring
    # reaches), the dead rows' state cotangent stays 0 through the walk and
    # their parameter terms are exactly 0: the live rows alone give the
    # same parameter cotangent
    grow = torch.arange(rows)[:, None] + row0
    live = ((grow >= 0) & (grow < H_GLOBAL)).expand(rows, W)
    masks = cloth_kernel._window_masks(rows, W, row0, H_GLOBAL, "cpu")
    cp, cv = wp * live, wv * live
    for s_in in reversed(traj):
        full = cg._substep_vjp_planes(s_in, cp, cv, prm, pins_t, masks)
        part = cg._substep_vjp_planes(s_in, cp, cv, prm, pins_t, masks,
                                      live)
        assert torch.equal(full[2], part[2])
        cp, cv = full[0], full[1]
        assert not bool(cp[:, ~live].any() or cv[:, ~live].any())


def test_multi_step_window_forward_is_the_stepper_and_dispatches():
    """The autograd Function's forward is ``multi_step_window_packed`` bit
    for bit (the trace's state n too); other devices raise."""
    s, prm = _contact_grid(True)
    win = [_window_of(a, -4, 12, H_GLOBAL)
           for a in (s.pos, s.vel, s.pin_mask, s.pin_pos)]
    pos = win[0].clone().requires_grad_(True)
    got = cg.multi_step_window(pos, win[1], win[2], win[3], prm, 3, -4,
                               H_GLOBAL)
    ref = cloth_kernel.multi_step_window_packed(*win, prm, 3, -4, H_GLOBAL)
    traj = cloth_kernel.trace_window(*win, prm, 4, -4, H_GLOBAL)
    for a, b, t in zip(got, ref, (traj[3, :3], traj[3, 3:])):
        assert torch.equal(a.detach(), b) and torch.equal(b, t)
    assert got[0].grad_fn is not None
    meta = torch.empty((3, 16, W), device="meta")
    with pytest.raises(ValueError, match="no cloth"):
        cg.multi_step_window(meta, meta, None, None, prm, 1, 0, H_GLOBAL)
    with pytest.raises(ValueError, match="no cloth"):
        cloth_kernel.trace_window(meta, meta, None, None, prm, 2, 0,
                                  H_GLOBAL)


# ---------------------------------------------------------------------------
# The sharded gradient on CPU shards
# ---------------------------------------------------------------------------

N_SHARDED, K_SHARDED = 8, 2


def _sharded_problem(pins):
    """Two 16² worlds with random velocities (and the top rows pinned),
    a trajectory-matching target from k = 450, and loss weights."""
    c = tcfg.ClothConfig(height=16, width=16)
    params = tstate.ClothParams.from_config(c, device="cpu")
    s = tstate.init_cloth_state(c, device="cpu")
    rng = np.random.default_rng(9)
    pos = torch.stack([s.pos] * 2) + torch.tensor(
        0.3 * rng.standard_normal((2, 3, 16, 16)), dtype=torch.float32)
    vel = torch.tensor(rng.standard_normal((2, 3, 16, 16)),
                       dtype=torch.float32)
    state = tstate.ClothState(pos=pos, vel=vel)
    if pins:
        mask = torch.zeros((2, 16, 16), dtype=torch.bool)
        mask[:, 0] = True
        state = state._replace(pin_mask=mask, pin_pos=pos.clone())
    target = torch.tensor(rng.standard_normal((2, 3, 16, 16)),
                          dtype=torch.float32)
    return state, params, target


def _sharded_grads(state, params, target, how):
    """d loss/d (log k_struct, pos0[, pin_pos]) of ``mean((pos − target)²)``
    after N_SHARDED substeps at k = 430: through the composed (2, 2) mesh
    (``how`` "window" or "stencil") or world by world on the whole grid
    (``cloth_grad_kernel.multi_step``)."""
    log_k = torch.log(torch.tensor(430.0)).requires_grad_(True)
    pos0 = state.pos.clone().requires_grad_(True)
    leaves = [log_k, pos0]
    st = state._replace(pos=pos0)
    if state.pin_pos is not None:
        pin_pos = state.pin_pos.clone().requires_grad_(True)
        leaves.append(pin_pos)
        st = st._replace(pin_pos=pin_pos)
    p = params._replace(k_struct=torch.exp(log_k))
    if how == "whole":
        outs = [cg.multi_step(tstate.ClothState(
            st.pos[b], st.vel[b],
            None if st.pin_mask is None else st.pin_mask[b],
            None if st.pin_pos is None else st.pin_pos[b]),
            p, mt.DT, N_SHARDED).pos for b in range(2)]
        out = torch.stack(outs)
    else:
        m = pmesh.make_mesh((2, 2), ("worlds", "rows"), ["cpu"] * 4)
        out = pmesh.batched_spatial_multi_step(
            st, p, mt.DT, N_SHARDED, m, substeps_per_exchange=K_SHARDED,
            use_kernel=how == "window").pos
    loss = torch.mean((out - target) ** 2)
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("pins", [False, True])
@pytest.mark.parametrize("ref,tol", [("whole", 1e-5), ("stencil", 1e-4)])
def test_sharded_gradient_matches_whole_grid_and_stencil(ref, tol, pins):
    state, params, target = _sharded_problem(pins)
    got = _sharded_grads(state, params, target, "window")
    want = _sharded_grads(state, params, target, ref)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert _max_rel(a, b) <= tol
    assert float(got[0].abs()) > 0
