"""Port parity, the multi-device cloth paths: ``parallel/mesh.py`` of the
port on CPU shards against the JAX package's ``parallel/mesh.py`` on the
conftest's 8 virtual CPU devices and its XLA paths.

The tests mirror ``tests/test_parallel.py`` case for case at its sizes
(16², 32×16), with inputs from numpy with a seed given to both packages.
JAX is held to its XLA paths only (``spatial_multi_step(...,
use_kernel=False)`` and ``cloth.multi_step``, the ``cloth.substep`` loop
under one jit), never Pallas in interpret mode. Tolerances, with their
reasons:

* the port against JAX: pos 1e-5, vel 1e-4, ``tests/test_parallel.py``'s
  own (XLA on the CPU contracts ``a*b + c`` into FMA, the port rounds
  twice);
* the port's rows path against the port's single-device stepper (the
  plain version of K1): bit for bit, since K1w's plain version is K1's
  with the spring masks taken from global rows; the port's stencil shard
  body against it: pos 1e-5, vel 1e-4 (another formulation);
* K1w's plain version on a window against K1's plain version on the whole
  grid: bit for bit on the window's centre rows.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.core import state as jstate
from wgpu_physics_engine_tpu.models import cloth as jcloth
from wgpu_physics_engine_tpu.parallel import mesh as jmesh
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.core import state as tstate
from wgpu_physics_engine_torch.models import cloth as tcloth
from wgpu_physics_engine_torch.ops import cloth_kernel
from wgpu_physics_engine_torch.parallel import mesh as pmesh

DT = 1.0 / 480.0


@pytest.fixture(scope="module")
def devices8():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual devices")
    return d[:8]


def _cpu_mesh(shape, names):
    return pmesh.make_mesh(shape, names, ["cpu"] * int(np.prod(shape)))


@functools.lru_cache(maxsize=None)
def _inputs(h, w, seed, pins, vel_scale=1.0):
    """The numpy start state (and its pins) of both packages."""
    js = jstate.init_cloth_state(jcfg.ClothConfig(height=h, width=w))
    pos = np.asarray(js.pos)
    vel = np.zeros((3, h, w), np.float32)
    if seed is not None:
        vel = (vel_scale * np.random.default_rng(seed).standard_normal(
            (3, h, w))).astype(np.float32)
    pin = None
    if pins:
        pin = np.zeros((h, w), bool)
        pin[0, :] = True
    return pos, vel, pin


def _jstate(pos, vel, pin):
    return jstate.ClothState(
        pos=jnp.asarray(pos), vel=jnp.asarray(vel),
        pin_mask=None if pin is None else jnp.asarray(pin),
        pin_pos=None if pin is None else jnp.asarray(pos))


def _tstate(pos, vel, pin):
    return tstate.ClothState(
        pos=torch.tensor(pos), vel=torch.tensor(vel),
        pin_mask=None if pin is None else torch.tensor(pin),
        pin_pos=None if pin is None else torch.tensor(pos))


def _params(h, w):
    return (jstate.ClothParams.from_config(jcfg.ClothConfig(height=h, width=w)),
            tstate.ClothParams.from_config(
                tcfg.ClothConfig(height=h, width=w), device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_substeps(h, w, seed, pins, n, vel_scale=1.0):
    """JAX's single-device reference: ``n`` × ``cloth.substep`` (its
    ``multi_step``, the substep loop under one jit), as numpy."""
    jp, _ = _params(h, w)
    out = jcloth.multi_step(_jstate(*_inputs(h, w, seed, pins, vel_scale)),
                            jp, jnp.float32(DT), n)
    return np.asarray(out.pos), np.asarray(out.vel)


def _close(got, ref_pos, ref_vel=None, pos_tol=1e-5, vel_tol=1e-4):
    np.testing.assert_allclose(got.pos.numpy(), ref_pos, atol=pos_tol,
                               rtol=0)
    if ref_vel is not None:
        np.testing.assert_allclose(got.vel.numpy(), ref_vel, atol=vel_tol,
                                   rtol=0)


def _equal(a, b):
    assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)


def test_worlds_sharding_matches_single(devices8):
    """Worlds-DP, 8 CPU shards: each world equals the single-world stepper
    bit for bit and JAX's ``cloth.multi_step`` within 1e-5."""
    pos, vel, _ = _inputs(16, 16, None, False)
    _, tp = _params(16, 16)
    m = _cpu_mesh((8,), ("worlds",))
    batched = tstate.ClothState(pos=torch.tensor(pos).expand(8, 3, 16, 16),
                                vel=torch.tensor(vel).expand(8, 3, 16, 16))
    out = pmesh.batched_multi_step(batched, tp, DT, 50, m)
    single = cloth_kernel.multi_step(_tstate(pos, vel, None), tp, DT, 50)
    ref_pos, _ = _jax_substeps(16, 16, None, False, 50)
    for i in range(8):
        assert torch.equal(out.pos[i], single.pos)
        np.testing.assert_allclose(out.pos[i].numpy(), ref_pos, atol=1e-5,
                                   rtol=0)


@functools.lru_cache(maxsize=None)
def _jax_spatial(h, w, seed, pins, n, n_shards, k, devices):
    """JAX's rows path with its XLA shard body, as numpy."""
    jp, _ = _params(h, w)
    m = jmesh.make_mesh((n_shards,), ("rows",), list(devices[:n_shards]))
    out = jmesh.spatial_multi_step(_jstate(*_inputs(h, w, seed, pins)), jp,
                                   jnp.float32(DT), n, m,
                                   substeps_per_exchange=k, use_kernel=False)
    return np.asarray(out.pos), np.asarray(out.vel)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_spatial_halo_matches_single(devices8, n_shards):
    """Row-sharded halo-exchange substeps (K1w's plain version a shard)
    equal the single-device stepper bit for bit, and JAX's rows path and
    its substep loop within 1e-5 / 1e-4."""
    inp = _inputs(32, 16, 0, False)
    _, tp = _params(32, 16)
    m = _cpu_mesh((n_shards,), ("rows",))
    out = pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 20, m)
    _equal(out, cloth_kernel.multi_step(_tstate(*inp), tp, DT, 20))
    _close(out, *_jax_spatial(32, 16, 0, False, 20, n_shards, 1,
                              tuple(devices8)))
    _close(out, *_jax_substeps(32, 16, 0, False, 20))


def test_spatial_with_pins(devices8):
    inp = _inputs(16, 16, None, True)
    _, tp = _params(16, 16)
    out = pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 30,
                                   _cpu_mesh((4,), ("rows",)))
    _close(out, _jax_substeps(16, 16, None, True, 30)[0])
    assert torch.equal(out.pos[:, 0], torch.tensor(inp[0])[:, 0])


@pytest.mark.parametrize("k", [2, 4])
def test_halo_widening_matches_single(devices8, k):
    """K substeps per halo exchange (2K-row halos) ≡ K plain substeps."""
    inp = _inputs(32, 16, 1, False)
    _, tp = _params(32, 16)
    out = pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 20,
                                   _cpu_mesh((4,), ("rows",)),
                                   substeps_per_exchange=k)
    _equal(out, cloth_kernel.multi_step(_tstate(*inp), tp, DT, 20))
    _close(out, *_jax_substeps(32, 16, 1, False, 20))


@pytest.mark.parametrize("k", [1, 4])
def test_spatial_kernel_matches_xla_path(devices8, k):
    """The window kernel's path (K1w's plain version) ≡ the stencil shard
    body (``spring_forces(row_valid=)``) ≡ JAX's XLA rows path ≡ the
    single-device substeps."""
    inp = _inputs(32, 16, 2, False)
    _, tp = _params(32, 16)
    m = _cpu_mesh((4,), ("rows",))
    out_k = pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 20, m,
                                     substeps_per_exchange=k, use_kernel=True)
    out_x = pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 20, m,
                                     substeps_per_exchange=k,
                                     use_kernel=False)
    _close(out_k, out_x.pos.numpy(), out_x.vel.numpy())
    _close(out_x, *_jax_spatial(32, 16, 2, False, 20, 4, k, tuple(devices8)))
    _close(out_k, *_jax_substeps(32, 16, 2, False, 20))


def test_spatial_kernel_with_pins_matches(devices8):
    inp = _inputs(16, 16, None, True)
    _, tp = _params(16, 16)
    out = pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 30,
                                   _cpu_mesh((4,), ("rows",)),
                                   substeps_per_exchange=2, use_kernel=True)
    _close(out, _jax_substeps(16, 16, None, True, 30)[0])
    assert torch.equal(out.pos[:, 0], torch.tensor(inp[0])[:, 0])


@pytest.mark.parametrize("use_kernel,k", [(False, 1), (True, 2)])
def test_composed_worlds_rows_matches_single(devices8, use_kernel, k):
    """Worlds-DP × rows-SP on a (2, 4) mesh, per-world pins and velocities,
    halo widening: each world ≡ its single-device substeps (JAX's within
    1e-5; the port's bit for bit on the kernel path), pinned row held."""
    _, tp = _params(16, 16)
    worlds = [_inputs(16, 16, 3 + i, True, 0.5) for i in range(4)]
    batched = tstate.ClothState(
        pos=torch.stack([torch.tensor(w[0]) for w in worlds]),
        vel=torch.stack([torch.tensor(w[1]) for w in worlds]),
        pin_mask=torch.stack([torch.tensor(w[2]) for w in worlds]),
        pin_pos=torch.stack([torch.tensor(w[0]) for w in worlds]))
    m = _cpu_mesh((2, 4), ("worlds", "rows"))
    out = pmesh.batched_spatial_multi_step(
        batched, tp, DT, 8, m, substeps_per_exchange=k, use_kernel=use_kernel)
    for i, w in enumerate(worlds):
        got = tstate.ClothState(pos=out.pos[i], vel=out.vel[i])
        _close(got, _jax_substeps(16, 16, 3 + i, True, 8, 0.5)[0])
        if use_kernel:
            _equal(got, cloth_kernel.multi_step(_tstate(*w), tp, DT, 8))
        assert torch.equal(out.pos[i][:, 0], torch.tensor(w[0])[:, 0])


def test_halo_widening_with_pins(devices8):
    inp = _inputs(16, 16, None, True)
    _, tp = _params(16, 16)
    out = pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 30,
                                   _cpu_mesh((4,), ("rows",)),
                                   substeps_per_exchange=2)
    _close(out, _jax_substeps(16, 16, None, True, 30)[0])


# ---------------------------------------------------------------------------
# K1w's plain version, the rest of the mesh API
# ---------------------------------------------------------------------------

def _window(x, lo, hi, h):
    """Rows [lo, hi) of ``x`` [..., h, W], zero where they leave the grid
    (what a boundary shard's halo receives)."""
    out = torch.zeros(x.shape[:-2] + (hi - lo, x.shape[-1]), dtype=x.dtype)
    a, b = max(lo, 0), min(hi, h)
    out[..., a - lo:b - lo, :] = x[..., a:b, :]
    return out


@pytest.mark.parametrize("where", ["top", "interior", "bottom"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("pins", [False, True], ids=["free", "pinned"])
def test_window_plain_matches_k1_plain(where, k, pins):
    """``multi_step_window_plain`` on a halo-extended window (row0 < 0 on
    the top shard) ≡ K1's plain version on the whole grid, bit for bit, on
    the window's centre rows after k substeps."""
    h, w, h_local = 24, 16, 8
    pos, vel, pin = _inputs(h, w, 11, pins)
    s = _tstate(pos, vel, pin)
    _, tp = _params(h, w)
    ref = cloth_kernel.multi_step_plain(s, tp, DT, k)
    i = {"top": 0, "interior": 1, "bottom": 2}[where]
    halo = 2 * k
    lo, hi = i * h_local - halo, (i + 1) * h_local + halo
    pm = None if pin is None else _window(s.pin_mask, lo, hi, h)
    pp = None if pin is None else _window(s.pin_pos, lo, hi, h)
    p, v = cloth_kernel.multi_step_window(
        _window(s.pos, lo, hi, h), _window(s.vel, lo, hi, h), pm, pp, tp, DT,
        k, lo, h)
    rows = slice(i * h_local, (i + 1) * h_local)
    assert torch.equal(p[:, halo:-halo], ref.pos[:, rows])
    assert torch.equal(v[:, halo:-halo], ref.vel[:, rows])


def test_spatial_substep_and_asserts(devices8):
    """One exchange block (``spatial_substep``) ≡ the single-device
    stepper; JAX's asserts (``n_steps % k``, ``HALO·k <= h_local``) and an
    uneven row cut raise."""
    inp = _inputs(32, 16, 5, False)
    _, tp = _params(32, 16)
    m = _cpu_mesh((4,), ("rows",))
    out = pmesh.spatial_substep(_tstate(*inp), tp, DT, m, substeps=2)
    _equal(out, cloth_kernel.multi_step(_tstate(*inp), tp, DT, 2))
    with pytest.raises(AssertionError, match="divisible"):
        pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 5, m,
                                 substeps_per_exchange=2)
    with pytest.raises(AssertionError, match="halo width"):
        pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 10, m,
                                 substeps_per_exchange=5)
    with pytest.raises(ValueError, match="not divisible"):
        pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 2,
                                 _cpu_mesh((3,), ("rows",)))


def test_make_mesh_and_dispatch():
    """Mesh shapes and repeated devices; no default mesh without CUDA;
    ``use_kernel=False`` on a CUDA mesh and K1w on another device type
    raise (no plain path runs on the card, no fallback)."""
    m = _cpu_mesh((2, 4), ("worlds", "rows"))
    assert m.shape == {"worlds": 2, "rows": 4}
    assert m.axis_devices("rows") == [torch.device("cpu")] * 4
    assert [len(r) for r in m.grid("worlds", "rows")] == [4, 4]
    with pytest.raises(ValueError, match="needs 3 devices"):
        pmesh.make_mesh((3,), ("rows",), ["cpu"] * 2)
    if torch.cuda.is_available():
        assert pmesh.make_mesh().axis_devices("worlds")[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.make_mesh()
    inp = _inputs(16, 16, None, False)
    _, tp = _params(16, 16)
    cuda_mesh = pmesh.make_mesh((4,), ("rows",), ["cuda:0"] * 4)
    with pytest.raises(ValueError, match="CPU shards only"):
        pmesh.spatial_multi_step(_tstate(*inp), tp, DT, 2, cuda_mesh,
                                 use_kernel=False)
    meta = torch.empty((3, 8, 16), device="meta")
    with pytest.raises(ValueError, match="no cloth stepper"):
        cloth_kernel.multi_step_window(meta, meta, None, None, tp, DT, 1, 0,
                                       8)


def test_batched_self_collide_matches_serial():
    """Worlds-DP self-collision on 2 CPU shards ≡ each world through
    ``models.cloth.multi_step_self_collide`` alone, bit for bit."""
    cloth_cfg = dict(height=12, width=12, cloth_size=2.0,
                     center=(0.0, 40.0, 0.0), particle_radius=0.12)
    tc = tcfg.ClothConfig(**cloth_cfg)
    tp = tstate.ClothParams.from_config(tc, device="cpu")
    spec = dataclasses.replace(
        tcloth.default_self_collision_grid(tc, skin=2 * tc.particle_radius),
        capacity=32)
    base = tstate.init_cloth_state(tc, device="cpu")
    rng = np.random.default_rng(4)
    vel = torch.tensor((0.5 * rng.standard_normal((4, 3, 12, 12))).astype(
        np.float32))
    batched = tstate.ClothState(pos=base.pos.expand(4, 3, 12, 12), vel=vel)
    out = pmesh.batched_self_collide_multi_step(
        batched, tp, DT, 6, spec, _cpu_mesh((2,), ("worlds",)),
        rebuild_every=4, pallas_block=128, pallas_slab=384)
    for i in range(4):
        ref = tcloth.multi_step_self_collide(
            tstate.ClothState(pos=base.pos, vel=vel[i]), tp, DT, 6, spec,
            rebuild_every=4, pallas_block=128, pallas_slab=384)
        assert torch.equal(out.pos[i], ref.pos)
        assert torch.equal(out.vel[i], ref.vel)
