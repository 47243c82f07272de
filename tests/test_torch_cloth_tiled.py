"""Port parity, the large-grid cloth path: ``ops.cloth_tiled_kernel`` (K6's
plain version, which CPU tensors take) and the route to it in
``ops.cloth_kernel.multi_step`` against the JAX banded kernel
(``cloth_pallas_tiled.multi_step`` in interpret mode) and the JAX XLA path
(``models.cloth.multi_step``), at JAX's own tolerances
(tests/test_cloth_pallas_tiled.py: pos 1e-5 and vel 1e-4; through impact
1e-4 abs and rel). Inputs come from numpy with a seed and go through both.

K6's plain version cuts the grid into tiles with a halo of 2k and steps
them k substeps under masks from grid indices; every cell it keeps must
equal K1's plain version (``cloth_kernel.multi_step_plain``) bit for bit,
whatever the tile, k, n_steps, grid shape or pins: the halo argument the
CUDA kernel relies on, checked where the kernel cannot run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.core import state as jstate
from wgpu_physics_engine_tpu.models import cloth as jcloth
from wgpu_physics_engine_tpu.ops import cloth_pallas, cloth_pallas_tiled
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.core import state as tstate
from wgpu_physics_engine_torch.models import cloth as tcloth
from wgpu_physics_engine_torch.ops import cloth_kernel, cloth_tiled_kernel

DT = 1.0 / 480.0
SHORT_FALL = dict(center=(0.0, 12.0, 0.0), cloth_size=8.0)
# vel bound of test_tiled_matches_jax. JAX's own test holds its two paths
# to 1e-4 on its own inputs; on these (velocities 0.5·N(0, 1) from numpy
# seed 0) its banded kernel and its XLA stencil part by 1.24e-4 after the
# 16 substeps of the second case, and the port by 1.90e-4 from either
# (1.2e-5 and 1.9e-5 in the first case): XLA on the CPU contracts
# ``a*b + c`` into FMAs and the port rounds twice (ROADMAP queue 3). The
# port's K6 equals its K1 bit for bit (below), so any gap to JAX is K1's.
VEL_TOL = 3e-4


def _pair(h, w, seed=None, pins=None, **kw):
    """The same initial state and params for both packages; ``pins`` is a
    list of the (row, col) cells to pin."""
    jc = jcfg.ClothConfig(height=h, width=w, **kw)
    js = jstate.init_cloth_state(jc)
    if seed is not None:
        rng = np.random.default_rng(seed)
        vel = (0.5 * rng.standard_normal((3, h, w))).astype(np.float32)
        js = js._replace(vel=jnp.asarray(vel))
    if pins is not None:
        pin = np.zeros((h, w), bool)
        for r, c in pins:
            pin[r, c] = True
        js = js._replace(pin_mask=jnp.asarray(pin), pin_pos=js.pos)
    jp = jstate.ClothParams.from_config(jc)
    ts = tstate.state_from_numpy(jstate.ClothState(
        *(None if a is None else np.asarray(a) for a in js)), device="cpu")
    tp = tstate.ClothParams.from_config(tcfg.ClothConfig(height=h, width=w,
                                                         **kw), device="cpu")
    return js, jp, ts, tp


def _close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol)


@pytest.fixture
def low_limit(monkeypatch):
    """Route every single-world grid above 1,000 particles to K6."""
    monkeypatch.setattr(cloth_kernel, "_TILED_PARTICLE_LIMIT", 1000)


@pytest.fixture
def tiled_calls(monkeypatch):
    """Count the calls that reach K6's plain version through the route."""
    calls = []
    plain = cloth_tiled_kernel.multi_step_plain_packed

    def counted(state, prm, n_steps, schedule=None):
        calls.append(tuple(state.pos.shape))
        return plain(state, prm, n_steps, schedule)

    monkeypatch.setattr(cloth_tiled_kernel, "multi_step_plain_packed", counted)
    return calls


# ---------------------------------------------------------------------------
# Against JAX (tests/test_cloth_pallas_tiled.py:14-84)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,k_sub", [((64, 32), 4), ((128, 16), 8)])
def test_tiled_matches_jax(hw, k_sub, low_limit):
    """pos within 1e-5 of both JAX paths, vel within VEL_TOL of both."""
    h, w = hw
    js, jp, ts, tp = _pair(h, w, seed=0)
    n = 2 * k_sub
    ref = jcloth.multi_step(js, jp, jnp.float32(DT), n)
    ref_t = cloth_pallas_tiled.multi_step(js, jp, jnp.float32(DT), n,
                                          k_sub=k_sub, interpret=True)
    plain = cloth_tiled_kernel.multi_step_plain(ts, tp, DT, n,
                                                schedule=(k_sub, 16, 16))
    routed = cloth_kernel.multi_step(ts, tp, DT, n)
    assert torch.equal(plain.pos, routed.pos)
    for got in (plain, routed):
        for r in (ref, ref_t):
            _close(got.pos, r.pos, 1e-5)
            _close(got.vel, r.vel, VEL_TOL)


def test_tiled_boundary_semantics_through_impact():
    """Short-fall scene through sphere impact: tile boundaries must not
    perturb the contact physics."""
    js, jp, ts, tp = _pair(64, 16, **SHORT_FALL)
    ref = jcloth.multi_step(js, jp, jnp.float32(DT), 320)
    ref_t = cloth_pallas_tiled.multi_step(js, jp, jnp.float32(DT), 320,
                                          k_sub=4, interpret=True)
    got = cloth_tiled_kernel.multi_step_plain(ts, tp, DT, 320,
                                              schedule=(4, 16, 8))
    assert float(torch.linalg.norm(got.pos, dim=0).min()) < 10.2  # impact
    for r in (ref, ref_t):
        _close(got.pos, r.pos, 1e-4, 1e-4)


def test_dispatcher_uses_tiled_beyond_limit(monkeypatch, tiled_calls):
    """multi_step routes a grid above the limit to K6 in both packages."""
    js, jp, ts, tp = _pair(512, 16)
    monkeypatch.setattr(cloth_pallas, "_VMEM_PARTICLE_LIMIT", 1000)
    monkeypatch.setattr(cloth_kernel, "_TILED_PARTICLE_LIMIT", 1000)
    out_j = cloth_pallas.multi_step(js, jp, jnp.float32(DT), 8,
                                    interpret=True)
    got = cloth_kernel.multi_step(ts, tp, DT, 8)
    ref = jcloth.multi_step(js, jp, jnp.float32(DT), 8)
    assert tiled_calls == [(3, 512, 16)]
    _close(got.pos, ref.pos, 1e-5)
    _close(got.pos, out_j.pos, 1e-5)


def test_tiled_pins():
    pins = [(0, c) for c in range(16)] + [(33, 7)]   # pins in other tiles
    js, jp, ts, tp = _pair(64, 16, pins=pins)
    ref = jcloth.multi_step(js, jp, jnp.float32(DT), 16)
    ref_t = cloth_pallas_tiled.multi_step(js, jp, jnp.float32(DT), 16,
                                          k_sub=4, interpret=True)
    got = cloth_tiled_kernel.multi_step_plain(ts, tp, DT, 16,
                                              schedule=(4, 16, 16))
    for r in (ref, ref_t):
        _close(got.pos, r.pos, 1e-5)
    np.testing.assert_array_equal(got.pos[:, 0].numpy(), ts.pos[:, 0].numpy())
    np.testing.assert_array_equal(got.pos[:, 33, 7].numpy(),
                                  ts.pos[:, 33, 7].numpy())


# ---------------------------------------------------------------------------
# K6's plain version against K1's, bit for bit
# ---------------------------------------------------------------------------

def _draped(h, w, pins=None):
    """A short-fall cloth stepped 300 substeps, onto the globe (contact,
    friction and projection run), then pinned at ``pins``."""
    _, _, ts, tp = _pair(h, w, seed=3, **SHORT_FALL)
    s = cloth_kernel.multi_step_plain(ts, tp, DT, 300)
    if pins is not None:
        pin = torch.zeros((h, w), dtype=torch.bool)
        for r, c in pins:
            pin[r, c] = True
        s = s._replace(pin_mask=pin, pin_pos=s.pos)
    return s, tp


def _contact_share(s, tp) -> float:
    r = torch.linalg.norm(s.pos, dim=0)
    return float((r < float(tp.globe_radius + tp.particle_radius) + 1e-3)
                 .float().mean())


@pytest.mark.parametrize("hw,schedule,n,pins", [
    ((40, 52), (4, 16, 16), 9, None),                 # n % k != 0, ragged
    ((33, 70), (1, 8, 8), 5, [(0, 3), (8, 8)]),       # k = 1, tile corner
    ((64, 32), (8, 16, 16), 19, [(16, 5), (30, 16)]),  # k = 8, tile edges
    ((37, 29), (3, 11, 13), 10, [(13, 11), (2, 2)]),  # pin inside a halo
    ((20, 20), (4, 64, 64), 8, None),                 # smaller than a tile
    ((50, 50), (2, 7, 30), 7, [(7, 29), (49, 49)]),   # odd tiles, corner pin
    ((24, 96), (4, 24, 32), 4, None),                 # one launch, exact tiles
])
def test_plain_tiled_equals_plain_k1_draped(hw, schedule, n, pins):
    h, w = hw
    s, tp = _draped(h, w, pins)
    assert _contact_share(s, tp) > 0
    ref = cloth_kernel.multi_step_plain(s, tp, DT, n)
    got = cloth_tiled_kernel.multi_step_plain(s, tp, DT, n,
                                              schedule=schedule)
    assert torch.equal(got.pos, ref.pos)
    assert torch.equal(got.vel, ref.vel)


@pytest.mark.parametrize("k_sub", [1, 4, 8])
@pytest.mark.parametrize("tile", [(8, 8), (16, 24), (13, 40)])
def test_plain_tiled_equals_plain_k1_free(k_sub, tile):
    """Random velocities, top row pinned, 13 substeps (not a multiple of
    4 or 8) on a ragged 45 × 61 grid."""
    top = [(0, c) for c in range(61)]
    _, _, ts, tp = _pair(45, 61, seed=11, pins=top)
    ref = cloth_kernel.multi_step_plain(ts, tp, DT, 13)
    got = cloth_tiled_kernel.multi_step_plain(ts, tp, DT, 13,
                                              schedule=(k_sub, *tile))
    assert torch.equal(got.pos, ref.pos)
    assert torch.equal(got.vel, ref.vel)
    assert torch.equal(got.pos[:, 0], ts.pos[:, 0])


def test_schedule_and_launches(monkeypatch):
    ct = cloth_tiled_kernel
    slots = ct.SMS * ct.CTAS_PER_SM
    # whole waves of tiles two bands wide, in the shared memory a CTA has
    for side, waves in ((1024, 1), (2048, 4)):
        k, th, tw = ct.pick_schedule(side, side, 960)
        assert k == ct.K_SUB
        assert -(-side // th) * -(-side // tw) == waves * slots
        assert tw + 4 * (k - 1) <= ct.TILE_BANDS * ct.BAND
        assert ct.smem_bytes(side, side, k, th, tw) <= ct.SMEM_PER_CTA
    k, th, tw = ct.pick_schedule(512, 512, 960)
    assert -(-512 // th) * -(-512 // tw) <= slots and th >= ct.MIN_TILE_H
    # more substeps a launch: the halo's growth still fits the bands
    monkeypatch.setattr(ct, "K_SUB", 2)
    k, th, tw = ct.pick_schedule(1024, 1024, 960)
    assert k == 2 and tw + 4 <= ct.TILE_BANDS * ct.BAND
    assert ct.smem_bytes(1024, 1024, k, th, tw) <= ct.SMEM_PER_CTA
    # fewer substeps than K, and a grid smaller than one tile
    k, th, tw = ct.pick_schedule(10, 12, 1)
    assert k == 1 and th <= 10 and tw == 12
    assert cloth_tiled_kernel._launches(13, 4) == [4, 4, 4, 1]
    assert cloth_tiled_kernel._launches(8, 4) == [4, 4]
    _, _, ts, tp = _pair(8, 8)
    with pytest.raises(ValueError):
        cloth_tiled_kernel.multi_step_plain(ts, tp, DT, 3, schedule=(0, 8, 8))
    assert cloth_tiled_kernel.multi_step_plain(ts, tp, DT, 0) is ts


# ---------------------------------------------------------------------------
# The route
# ---------------------------------------------------------------------------

def test_route_cpu_takes_tiled_plain(low_limit, tiled_calls):
    """A [3, H, W] CPU state above the limit takes K6's plain version,
    exact with or without fast_math (JAX drops fast_math on this route)."""
    _, _, ts, tp = _pair(40, 40, seed=2, pins=[(0, 0), (0, 39)])
    exact = cloth_kernel.multi_step_plain(ts, tp, DT, 10)
    got = cloth_kernel.multi_step(ts, tp, DT, 10)
    fast = cloth_kernel.multi_step(ts, tp, DT, 10, fast_math=True)
    assert tiled_calls == [(3, 40, 40)] * 2
    for out in (got, fast):
        assert torch.equal(out.pos, exact.pos)
        assert torch.equal(out.vel, exact.vel)


def test_route_batched_stays_on_k5(low_limit, tiled_calls):
    """A [B, 3, H, W] batch above the limit stays on K5's plain version."""
    _, _, ts, tp = _pair(40, 40, seed=4)
    batch = ts._replace(pos=torch.stack([ts.pos, ts.pos + 0.5]),
                        vel=torch.stack([ts.vel, -ts.vel]))
    got = cloth_kernel.multi_step(batch, tp, DT, 6)
    ref = cloth_kernel.multi_step_plain(batch, tp, DT, 6)
    assert tiled_calls == []
    assert torch.equal(got.pos, ref.pos)
    assert torch.equal(got.vel, ref.vel)


def test_route_at_or_below_limit_unchanged(monkeypatch, tiled_calls):
    _, _, ts, tp = _pair(40, 25, seed=6)
    monkeypatch.setattr(cloth_kernel, "_TILED_PARTICLE_LIMIT", 40 * 25)
    exact = cloth_kernel.multi_step_plain(ts, tp, DT, 5)
    fast = cloth_kernel.multi_step_plain(ts, tp, DT, 5, fast_math=True)
    got = cloth_kernel.multi_step(ts, tp, DT, 5)
    got_fast = cloth_kernel.multi_step(ts, tp, DT, 5, fast_math=True)
    assert tiled_calls == []
    assert torch.equal(got.pos, exact.pos)
    assert torch.equal(got_fast.pos, fast.pos)
    assert cloth_kernel._TILED_PARTICLE_LIMIT == 40 * 25
    monkeypatch.undo()
    assert cloth_kernel._TILED_PARTICLE_LIMIT == 100_000


def test_route_other_device_raises(low_limit):
    c = tcfg.ClothConfig(height=40, width=40)
    s = tstate.init_cloth_state(c, device="meta")
    p = tstate.ClothParams.from_config(c, device="meta")
    with pytest.raises(ValueError, match="no cloth stepper"):
        cloth_kernel.multi_step(s, p, DT, 4)
    with pytest.raises(ValueError, match="no cloth stepper"):
        cloth_tiled_kernel.multi_step(s, p, DT, 4)


def test_kernel_wrapper_refuses_cpu_and_batches():
    _, _, ts, tp = _pair(16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        cloth_tiled_kernel.multi_step_kernel(ts, tp, DT, 4)
    with pytest.raises(ValueError, match="one world"):
        cloth_tiled_kernel.multi_step_plain(
            ts._replace(pos=ts.pos[None], vel=ts.vel[None]), tp, DT, 4)


def test_scene_routes_large_grid(low_limit, tiled_calls):
    """``ClothScene`` above the limit steps through K6 (its plain version
    on the CPU) and ends where the scene on K1 ends, bit for bit."""
    from wgpu_physics_engine_torch.models.scenes import ClothScene

    c = tcfg.ClothConfig(height=36, width=36)
    scene = ClothScene(c, device="cpu")
    scene.simulate(0.05)
    scene.update(1.0 / 60.0)
    assert tiled_calls == [(3, 36, 36)] * 2
    ref = tstate.init_cloth_state(c, device="cpu")
    ref = cloth_kernel.multi_step_plain(ref, scene.params, 1.0 / 480.0, 24)
    n, sub_dt = tcloth.frame_substeps(1.0 / 60.0, c.time_scale, c.hz,
                                      c.max_substeps)
    ref = cloth_kernel.multi_step_plain(ref, scene.params, sub_dt, n)
    assert torch.equal(scene.state.pos, ref.pos)
    assert torch.equal(scene.state.vel, ref.vel)


# ---------------------------------------------------------------------------
# Gradients through the route
# ---------------------------------------------------------------------------

def test_multi_step_diff_through_route_bitwise(monkeypatch, tiled_calls):
    """``models.cloth.multi_step_diff`` at a routed size: its forward
    segments take K6's plain version, its backward's trace K1's, and the
    primal and every gradient equal the same call with the route off, bit
    for bit."""
    h = w = 24
    pins = [(0, c) for c in range(w)]
    _, _, ts, tp = _pair(h, w, seed=8, pins=pins, **SHORT_FALL)
    rng = np.random.default_rng(9)
    wp, wv = (torch.tensor(rng.standard_normal((3, h, w)).astype(np.float32))
              for _ in range(2))

    def grads():
        leaves = [a.detach().clone().requires_grad_(True) for a in tp]
        pos, vel, pin_pos = (a.detach().clone().requires_grad_(True)
                             for a in (ts.pos, ts.vel, ts.pin_pos))
        dt = torch.tensor(DT, requires_grad=True)
        out = tcloth.multi_step_diff(
            ts._replace(pos=pos, vel=vel, pin_pos=pin_pos),
            tstate.ClothParams(*leaves), dt, 10, segment=4)
        loss = (out.pos * wp).sum() + (out.vel * wv).sum()
        return out, torch.autograd.grad(loss, [pos, vel, pin_pos, *leaves,
                                               dt])

    out_off, g_off = grads()
    assert tiled_calls == []
    monkeypatch.setattr(cloth_kernel, "_TILED_PARTICLE_LIMIT", 100)
    out_on, g_on = grads()
    assert tiled_calls == [(3, h, w)] * 3          # segments of 4, 4, 2
    assert torch.equal(out_on.pos, out_off.pos)
    assert torch.equal(out_on.vel, out_off.vel)
    assert any(float(g.abs().max()) > 0 for g in g_on)
    for a, b in zip(g_on, g_off):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# K6w: the row window on the tiles (the rows-sharded path's shard body)
# ---------------------------------------------------------------------------

def _window_rows(x, lo, hi, h):
    """Rows [lo, hi) of ``x`` [..., h, W], zero where they leave the grid
    (what a boundary shard's halo receives)."""
    out = torch.zeros(x.shape[:-2] + (hi - lo, x.shape[-1]), dtype=x.dtype)
    a, b = max(lo, 0), min(hi, h)
    out[..., a - lo:b - lo, :] = x[..., a:b, :]
    return out


@pytest.fixture(scope="module")
def draped_48x40():
    """The draped 48 × 40 cloth (contact, friction and projection run)
    and its params, pinned along the top row and at (20, 5)."""
    s, tp = _draped(48, 40, [(0, c) for c in range(40)] + [(20, 5)])
    assert _contact_share(s, tp) > 0
    return s, tp


@pytest.mark.parametrize("where", ["top", "middle", "bottom"])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("pins", [False, True], ids=["free", "pinned"])
def test_window_tiled_plain_equals_k1w_plain(draped_48x40, where, k, pins):
    """K6w's plain version (the tiles with K1w's global-row masks) ≡
    ``cloth_kernel.multi_step_window_plain`` bit for bit on the whole
    window, halo and dead rows included: the top window (row0 < 0, zero
    leading rows) and the bottom one (rows past the grid), at k ∈ {1, 2}
    a launch, on ragged tiles, on one tile taller than the window and on
    the default schedule."""
    s, tp = draped_48x40
    h, h_local = 48, 16
    i = {"top": 0, "middle": 1, "bottom": 2}[where]
    halo = 2 * k
    lo, hi = i * h_local - halo, (i + 1) * h_local + halo
    args = [_window_rows(a, lo, hi, h) for a in (s.pos, s.vel)]
    args += ([_window_rows(s.pin_mask, lo, hi, h),
              _window_rows(s.pin_pos, lo, hi, h)] if pins else [None, None])
    ref = cloth_kernel.multi_step_window_plain(*args, tp, DT, 5, lo, h)
    for schedule in ((k, 5, 13), (1, 7, 9), (k, 64, 64), None):
        got = cloth_tiled_kernel.multi_step_window_plain(
            *args, tp, DT, 5, lo, h, schedule=schedule)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    if where != "middle":                     # the dead rows moved
        dead = slice(0, halo) if where == "top" else slice(-halo, None)
        assert not torch.equal(ref[0][:, dead], args[0][:, dead])


@pytest.mark.parametrize("where", ["top", "bottom"])
def test_window_route_takes_tiled_plain_and_matches_jax(monkeypatch,
                                                        where):
    """Above the (lowered) limit ``cloth_kernel.multi_step_window`` takes
    K6w's plain version (and K1w's at or under it), and one substep of the
    top or bottom window equals ``cloth_pallas.multi_step_window`` through
    JAX (interpret mode) within the one-substep contract (1e-6)."""
    h, w, h_local, k = 48, 40, 16, 1
    js, jp, ts, tp = _pair(h, w, seed=5, pins=[(0, c) for c in range(w)])
    i = {"top": 0, "bottom": 2}[where]
    lo, hi = i * h_local - 2 * k, (i + 1) * h_local + 2 * k
    args = [_window_rows(a, lo, hi, h)
            for a in (ts.pos, ts.vel, ts.pin_mask, ts.pin_pos)]
    calls = []
    plain = cloth_tiled_kernel.multi_step_window_plain

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return plain(*a, **kw)

    monkeypatch.setattr(cloth_tiled_kernel, "multi_step_window_plain",
                        counted)
    monkeypatch.setattr(cloth_kernel, "_TILED_PARTICLE_LIMIT",
                        (hi - lo) * w)
    small = cloth_kernel.multi_step_window(*args, tp, DT, k, lo, h)
    assert calls == []
    monkeypatch.setattr(cloth_kernel, "_TILED_PARTICLE_LIMIT",
                        (hi - lo) * w - 1)
    got = cloth_kernel.multi_step_window(*args, tp, DT, k, lo, h)
    assert calls == [(3, hi - lo, w)]
    assert torch.equal(got[0], small[0]) and torch.equal(got[1], small[1])
    jargs = [jnp.asarray(a.numpy()) for a in args]
    ref = cloth_pallas.multi_step_window(*jargs, jp, jnp.float32(DT), k, lo,
                                         h, interpret=True)
    _close(got[0], ref[0], 1e-6)
    _close(got[1], ref[1], 1e-6)
