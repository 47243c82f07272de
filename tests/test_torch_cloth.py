"""Port parity, cloth physics: ``models.cloth`` (the stencil twin) against
the JAX XLA path, and ``ops.cloth_kernel`` (the fused-substep kernel's
plain version, which CPU tensors take) against the JAX Pallas kernel in
interpret mode. Inputs come from numpy with a seed and go through both.

Tolerances are the JAX suite's own contracts: 1e-6 for one substep and
1e-4 / 1e-3 (pos / vel) through impact (test_cloth_vs_oracle.py:62-102);
1e-5 / 1e-4 for the fused kernel vs a stencil path and 1e-4 for fast_math
vs exact (test_cloth_pallas.py:30-34,70-82).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.core import state as jstate
from wgpu_physics_engine_tpu.models import cloth as jcloth
from wgpu_physics_engine_tpu.ops import cloth_pallas
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.core import state as tstate
from wgpu_physics_engine_torch.models import cloth as tcloth
from wgpu_physics_engine_torch.ops import cloth_kernel

DT = 1.0 / 480.0


def _pair(h, w, seed=None, vel_scale=0.5, pins=False, **kw):
    """The same initial state and params for both packages."""
    jc = jcfg.ClothConfig(height=h, width=w, **kw)
    js = jstate.init_cloth_state(jc)
    if seed is not None:
        rng = np.random.default_rng(seed)
        vel = (vel_scale * rng.standard_normal((3, h, w))).astype(np.float32)
        js = js._replace(vel=jnp.asarray(vel))
    if pins:
        pin = np.zeros((h, w), bool)
        pin[0, :] = True
        js = js._replace(pin_mask=jnp.asarray(pin), pin_pos=js.pos)
    jp = jstate.ClothParams.from_config(jc)
    ts = tstate.state_from_numpy(jstate.ClothState(
        *(None if a is None else np.asarray(a) for a in js)), device="cpu")
    tp = tstate.ClothParams.from_config(
        tcfg.ClothConfig(height=h, width=w, **kw), device="cpu")
    return js, jp, ts, tp


def _close(got, ref, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=atol)


def test_pack_params_bitwise():
    js, jp, ts, tp = _pair(8, 8, speed_damp=0.9)
    got = cloth_kernel._pack_params(tp, DT).numpy()
    ref = np.asarray(cloth_pallas._pack_params(jp, jnp.float32(DT)))
    assert got.dtype == np.float32 and got.shape == (16,)
    np.testing.assert_array_equal(got[:13], ref[:13])
    np.testing.assert_array_equal(got[14:], ref[14:])
    # speed_damp ** dt: two libms may round pow differently by 1 ulp
    np.testing.assert_allclose(got[13], ref[13], rtol=2e-7, atol=0)


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)])
def test_single_substep_matches_jax(hw):
    js, jp, ts, tp = _pair(*hw, seed=1)
    ref = jax.jit(jcloth.substep)(js, jp, jnp.float32(DT))
    got = tcloth.substep(ts, tp, DT)
    _close(got.pos, ref.pos, 1e-6)
    _close(got.vel, ref.vel, 1e-6)


def test_spring_forces_match_jax():
    js, jp, ts, tp = _pair(12, 20, seed=2)
    ref = jax.jit(jcloth.spring_forces)(js.pos, js.vel, jp)
    got = tcloth.spring_forces(ts.pos, ts.vel, tp)
    _close(got, ref, 1e-5)


def test_multi_step_through_impact_matches_jax():
    """16×16 cloth from y=40: free fall, impact at ~2.47 s, then contact,
    friction and projection (1230 substeps)."""
    js, jp, ts, tp = _pair(16, 16)
    ref = jcloth.multi_step(js, jp, jnp.float32(DT), 1230)
    got = tcloth.multi_step(ts, tp, DT, 1230)
    assert torch.isfinite(got.pos).all()
    r = torch.linalg.norm(got.pos, dim=0)
    assert float(r.min()) < 10.2             # the cloth reached the globe
    _close(got.pos, ref.pos, 1e-4)
    _close(got.vel, ref.vel, 1e-3)


@pytest.mark.parametrize("delta", [1 / 60, 1 / 240, 1 / 30])
def test_frame_substeps_and_update_match_jax(delta):
    assert tcloth.frame_substeps(delta, 1.3) == jcloth.frame_substeps(delta, 1.3)
    js, jp, ts, tp = _pair(8, 12, seed=3)
    ref = jcloth.frame_update(js, jp, delta, time_scale=1.3)
    got = tcloth.frame_update(ts, tp, delta, time_scale=1.3)
    _close(got.pos, ref.pos, 1e-6)


@pytest.mark.parametrize("hw", [(16, 16), (8, 24)])
def test_kernel_plain_matches_pallas(hw):
    js, jp, ts, tp = _pair(*hw, seed=1)
    ref = cloth_pallas.multi_step(js, jp, jnp.float32(DT), 40, interpret=True)
    got = cloth_kernel.multi_step(ts, tp, DT, 40)
    _close(got.pos, ref.pos, 1e-5)
    _close(got.vel, ref.vel, 1e-4)


def test_kernel_plain_pins_match_pallas():
    js, jp, ts, tp = _pair(16, 16, pins=True)
    ref = cloth_pallas.multi_step(js, jp, jnp.float32(DT), 60, interpret=True)
    got = cloth_kernel.multi_step(ts, tp, DT, 60)
    _close(got.pos, ref.pos, 1e-5)
    # pinned rows hold bitwise
    np.testing.assert_array_equal(got.pos[:, 0].numpy(), ts.pos[:, 0].numpy())
    np.testing.assert_array_equal(got.pos[:, 0].numpy(),
                                  np.asarray(ref.pos)[:, 0])
    assert (got.vel[:, 0] == 0).all()


def test_kernel_plain_fast_math_within_bar():
    """fast_math (rsqrt) stays within 1e-4 of the exact path through
    impact, on a short-fall scene (impact within ~180 substeps), and the
    port's fast path stays within the same bar of the Pallas fast path."""
    kw = dict(center=(0.0, 12.0, 0.0), cloth_size=8.0)
    js, jp, ts, tp = _pair(16, 16, **kw)
    exact = cloth_kernel.multi_step(ts, tp, DT, 330)
    fast = cloth_kernel.multi_step(ts, tp, DT, 330, fast_math=True)
    np.testing.assert_allclose(fast.pos.numpy(), exact.pos.numpy(),
                               atol=1e-4, rtol=1e-4)
    ref = cloth_pallas.multi_step(js, jp, jnp.float32(DT), 330,
                                  interpret=True, fast_math=True)
    _close(fast.pos, ref.pos, 1e-4)


def test_kernel_plain_matches_stencil_twin():
    """The fused substep's plain version and the stencil path differ only
    in the rounding of the edge-force sum, as in the JAX package."""
    _, _, ts, tp = _pair(12, 20, seed=4)
    a = cloth_kernel.multi_step(ts, tp, DT, 40)
    b = tcloth.multi_step(ts, tp, DT, 40)
    np.testing.assert_allclose(a.pos.numpy(), b.pos.numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(a.vel.numpy(), b.vel.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_kernel_plain_zero_steps_is_identity():
    _, _, ts, tp = _pair(8, 8, seed=5)
    got = cloth_kernel.multi_step(ts, tp, DT, 0)
    np.testing.assert_array_equal(got.pos.numpy(), ts.pos.numpy())


H100_SMEM = 232_448      # the H100's shared memory a CTA can opt in to
A100_SMEM = 166_912


@pytest.mark.parametrize("n_worlds,hw,fast,sms,smem,takes", [
    (1024, (60, 60), False, 132, H100_SMEM, True),   # the datagen chunk
    (64, (60, 60), False, 132, H100_SMEM, True),     # the datagen CLI
    (50, (60, 60), False, 132, H100_SMEM, True),     # 0.375 worlds an SM
    (49, (60, 60), False, 132, H100_SMEM, False),
    (16, (60, 60), False, 132, H100_SMEM, False),    # a multi-device shard
    (24, (60, 60), False, 64, H100_SMEM, True),      # a smaller card
    (23, (60, 60), False, 64, H100_SMEM, False),
    (1024, (60, 60), True, 132, H100_SMEM, False),   # fast_math stays on K5
    (1024, (69, 70), False, 132, H100_SMEM, True),   # 4,830, 231,840 B
    (1024, (70, 70), False, 132, H100_SMEM, False),  # 4,900: overflows
    (65536, (8, 8), False, 132, H100_SMEM, False),   # more than a grid's z
    (1024, (60, 60), False, 108, A100_SMEM, False),  # 172,800 B: no room
    (1024, (57, 60), False, 108, A100_SMEM, True),   # 164,160 B
])
def test_resident_batch_route(n_worlds, hw, fast, sms, smem, takes):
    """The batch route (K5r or K5) as a pure function of the batch's shape,
    the card's multiprocessors and shared memory, and fast_math."""
    assert cloth_kernel.resident_batch(n_worlds, *hw, fast, sms,
                                       smem) is takes
