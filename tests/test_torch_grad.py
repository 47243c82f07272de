"""Port parity, gradients through the cloth: ``ops.cloth_grad_kernel`` (the
hand-written substep adjoint's plain version, the segment-checkpointed
``torch.autograd.Function``) and ``models.cloth.multi_step_diff`` against
``torch.autograd`` of the transcribed pure functions and against
``jax.grad`` of the JAX package. Inputs are made with numpy from a seed and
carried across with ``params_from_numpy``/``state_from_numpy``.

Tolerances are the JAX suite's (tests/test_cloth_grad.py): 1e-5
max-relative against a mirror with the adjoint's own expressions, even in
the contact regime; 2e-4 against the production XLA path in the smooth
regime (springs stretched, no contact), where ~1-ulp primal differences
cannot flip a branch; 1e-4 against the Pallas backward in interpret mode.

Across the two frameworks the contact regime is held on states built off
the contact knife edge. On the draped cloth of the JAX suite, particles
rest exactly on the projection radius, so ``dist < min_dist`` is decided
by the last bit; XLA on the CPU contracts ``a*b + c`` into one FMA while
the port (and its CUDA kernels) round twice, so the two take different
branches (gradients 1.7e-4 apart after one substep, 4.7e-2 after two).
The "bounce" state puts a patch of the cloth inside the contact distance
by a margin, moving out fast enough to leave it in one substep (contact
and friction run, nothing lands on the sphere); the "impact" state puts
most of it deep inside, moving in (contact, friction and projection run)
for one substep. The draped cloth itself is used within the port: the
hand adjoint against ``torch.autograd`` (b), the primal (f).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.core import state as jstate
from wgpu_physics_engine_tpu.models import cloth as jcloth
from wgpu_physics_engine_tpu.ops import cloth_pallas as jcp
from wgpu_physics_engine_tpu.ops import cloth_pallas_grad as jcpg
from wgpu_physics_engine_torch.core import state as tstate
from wgpu_physics_engine_torch.examples import differentiable_cloth
from wgpu_physics_engine_torch.models import cloth as tcloth
from wgpu_physics_engine_torch.ops import cloth_grad_kernel as cg
from wgpu_physics_engine_torch.ops import cloth_kernel

H, W = 12, 16
DT = 1.0 / 480.0
JDT = jnp.float32(DT)


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-8)


def _np(t):
    return t.detach().cpu().numpy()


def _to_torch(js):
    return tstate.state_from_numpy(jstate.ClothState(
        *(None if a is None else np.asarray(a) for a in js)), device="cpu")


def _jax_scene(h, w, seed=0):
    """Params, the contact state (1500 substeps: dropped onto the globe,
    contact, friction and projection active), the smooth state (mid-fall,
    springs stretched by noise) and two loss weights, from the JAX
    package."""
    c = jcfg.ClothConfig(height=h, width=w)
    jp = jstate.ClothParams.from_config(c)
    s0 = jstate.init_cloth_state(c)
    rng = np.random.default_rng(seed)
    contact = jcloth.multi_step(s0, jp, JDT, 1500)
    noise = (0.2 * rng.standard_normal((3, h, w))).astype(np.float32)
    smooth = jcloth.multi_step(s0._replace(pos=s0.pos + noise), jp, JDT, 50)
    wp = rng.standard_normal((3, h, w)).astype(np.float32)
    wv = rng.standard_normal((3, h, w)).astype(np.float32)
    return jp, contact, smooth, wp, wv


@pytest.fixture(scope="module")
def scene():
    return _jax_scene(H, W)


def _off_edge(h, w, kind, seed=3):
    """A small cloth (side 3) at the top of the globe, off the contact knife
    edge: ``bounce`` sits up to ~0.01 inside the contact distance and moves
    out at 8 m/s (one substep leaves it); ``impact`` sits up to 0.1 inside
    and moves in at 1 m/s. Tangential velocities and a little noise make
    the springs and friction work."""
    y, vy = {"bounce": (10.09, 8.0), "impact": (10.0, -1.0)}[kind]
    c = jcfg.ClothConfig(height=h, width=w, cloth_size=3.0,
                         center=(0.0, y, 0.0))
    s0 = jstate.init_cloth_state(c)
    rng = np.random.default_rng(seed)
    pos = np.asarray(s0.pos) + (0.002 * rng.standard_normal((3, h, w))
                                ).astype(np.float32)
    vel = (0.5 * rng.standard_normal((3, h, w))).astype(np.float32)
    vel[1] = vy
    js = s0._replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel))
    jp = jstate.ClothParams.from_config(c)
    x = pos.astype(np.float64)
    n_in = int((np.sqrt((x * x).sum(0)) < float(c.globe_radius
                                                 + c.particle_radius)).sum())
    assert n_in > 0                          # the contact branches run
    return jp, js


def _pinned(js):
    pin = np.zeros(js.pos.shape[-2:], bool)
    pin[0] = True
    return js._replace(pin_mask=jnp.asarray(pin), pin_pos=js.pos)


# ---------------------------------------------------------------------------
# (a) The NaN-gradient fault: a particle at x = z = 0 has a zero friction
# tangent under gravity alone, and d sqrt/dx at 0 is inf
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(6, 6), (16, 16)])
@pytest.mark.parametrize("stepper", ["model", "plain"])
def test_grad_through_steppers_is_finite_and_matches_jax(hw, stepper):
    h, w = hw
    c = jcfg.ClothConfig(height=h, width=w)
    jp = jstate.ClothParams.from_config(c)
    js = jstate.init_cloth_state(c)
    assert np.any((np.asarray(js.pos[0]) == 0) & (np.asarray(js.pos[2]) == 0))

    def jloss(pms):
        return jnp.mean(jcloth.multi_step(js, pms, JDT, 4).pos[1])

    ref = jax.grad(jloss)(jp)
    leaves = [a.requires_grad_(True)
              for a in tstate.params_from_numpy(jp, device="cpu")]
    step = tcloth.multi_step if stepper == "model" else cloth_kernel.multi_step
    out = step(_to_torch(js), tstate.ClothParams(*leaves), DT, 4)
    grads = torch.autograd.grad(out.pos[1].mean(), leaves)
    for name, a, b in zip(tstate.ClothParams._fields, grads, ref):
        a, b = _np(a), np.asarray(b)
        assert np.isfinite(a).all(), name
        if abs(float(b)) < 1e-9:
            assert abs(float(a)) < 1e-9, name
            continue
        assert _max_rel(a, b) < 2e-4, name
    np.testing.assert_allclose(_np(grads[12]), 4.3402775e-05, rtol=2e-4)


# ---------------------------------------------------------------------------
# (b) The hand adjoint of one substep against torch.autograd of the
# transcribed pure functions
# ---------------------------------------------------------------------------

def _autograd_substep(planes, prm, pins):
    """One substep from ``_family_force`` and ``_integrate_planes``."""
    x, y, z, vx, vy, vz = planes.unbind(0)
    h, w = x.shape
    masks = cloth_kernel._family_masks(h, w, x.device)
    fx = torch.zeros_like(x)
    fy = torch.zeros_like(x)
    fz = torch.zeros_like(x)
    for fam_idx, (dr, dc, t) in enumerate(cloth_kernel._FAMILIES):
        gx, gy, gz = cg._family_force(x, y, z, vx, vy, vz, prm[t], prm[3 + t],
                                      prm[6 + t], dr=dr, dc=dc,
                                      ok=masks[fam_idx])
        fx, fy, fz = fx + gx, fy + gy, fz + gz
    args = (x, y, z, vx, vy, vz, fx, fy, fz, *prm[9:16].unbind(0))
    if pins is None:
        return cg._integrate_planes(*args)
    return cg._integrate_planes(*args, *pins[1].unbind(0), pin=pins[0])


@pytest.mark.parametrize("pinned", [False, True])
def test_substep_vjp_plain_matches_autograd_with_contact(scene, pinned):
    jp, contact, _, wp, wv = scene
    js = _pinned(contact) if pinned else contact
    ts = _to_torch(js)
    prm = cloth_kernel._pack_params(
        tstate.params_from_numpy(jp, device="cpu"), DT)
    dist = torch.linalg.vector_norm(ts.pos, dim=0)
    assert int((dist < prm[14]).sum()) > 0        # contact branches run
    planes = torch.cat([ts.pos, ts.vel]).requires_grad_(True)
    prm_g = prm.clone().requires_grad_(True)
    pins = None
    pin_pos = None
    if pinned:
        pin_pos = ts.pin_pos.clone().requires_grad_(True)
        pins = (ts.pin_mask, pin_pos)
    out = _autograd_substep(planes, prm_g, pins)
    cp, cv = torch.tensor(wp), torch.tensor(wv)
    loss = (torch.stack(out[:3]) * cp).sum() + (torch.stack(out[3:]) * cv).sum()
    want = [prm_g, planes] + ([pin_pos] if pinned else [])
    ref = torch.autograd.grad(loss, want)
    got = cg.substep_vjp_plain(torch.cat([ts.pos, ts.vel]), cp, cv, prm,
                               None if not pinned else (ts.pin_mask, ts.pin_pos))
    assert _max_rel(_np(got[0]), _np(ref[1][:3])) < 1e-5
    assert _max_rel(_np(got[1]), _np(ref[1][3:])) < 1e-5
    assert _max_rel(_np(got[2]), _np(ref[0])) < 1e-5
    if pinned:
        assert _max_rel(_np(got[3]), _np(ref[2])) < 1e-5
        assert float(got[3].abs().max()) > 0
    else:
        assert got[3] is None


# ---------------------------------------------------------------------------
# (c) The segmented path against jax.grad of the JAX grad module's mirror
# (its own _family_force / _integrate_planes), with contact
# ---------------------------------------------------------------------------

def _mirror_multi(pos, vel, pvec, n, pinm=None, pinpos=None):
    """tests/test_cloth_grad.py's XLA mirror of the JAX backward's
    expressions."""
    h, w = pos.shape[-2:]
    masks = [jcp._family_masks(h, w, dr, dc) for dr, dc, _ in jcp._FAMILIES]
    k, c, rest = pvec[0:3], pvec[3:6], pvec[6:9]
    pin = None if pinm is None else (pinm != 0.0)

    def sub(carry, _):
        x, y, z, vx, vy, vz = carry
        fx = jnp.zeros((h, w), jnp.float32)
        fy = jnp.zeros_like(fx)
        fz = jnp.zeros_like(fx)
        for fam_idx, (dr, dc, t) in enumerate(jcp._FAMILIES):
            gx, gy, gz = jcpg._family_force(
                x, y, z, vx, vy, vz, k[t], c[t], rest[t],
                dr=dr, dc=dc, ok=masks[fam_idx], h=h, w=w)
            fx, fy, fz = fx + gx, fy + gy, fz + gz
        args = (x, y, z, vx, vy, vz, fx, fy, fz) + tuple(pvec[9:16])
        if pin is not None:
            args = args + (pinpos[0], pinpos[1], pinpos[2])
        return tuple(jcpg._integrate_planes(*args, pin=pin)), None

    carry = (pos[0], pos[1], pos[2], vel[0], vel[1], vel[2])
    carry, _ = jax.lax.scan(sub, carry, None, length=n)
    return jnp.stack(carry[:3]), jnp.stack(carry[3:])


@pytest.mark.parametrize("kind,pinned,n,segment", [
    ("bounce", False, 24, 8), ("bounce", True, 16, 6), ("impact", True, 1, 1)])
def test_segments_match_jax_mirror_with_contact(kind, pinned, n, segment):
    jp, js = _off_edge(H, W, kind)
    if pinned:
        js = _pinned(js)
    rng = np.random.default_rng(4)
    wp, wv = (rng.standard_normal((3, H, W)).astype(np.float32)
              for _ in range(2))
    pvec0 = jcp._pack_params(jp, JDT)
    pinm = None if not pinned else js.pin_mask.astype(jnp.float32)

    def jloss(pvec, pos, vel, pinpos):
        p, v = _mirror_multi(pos, vel, pvec, n, pinm, pinpos)
        return jnp.sum(p * wp) + jnp.sum(v * wv)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        pvec0, js.pos, js.vel, js.pos)

    ts = _to_torch(js)
    prm = torch.tensor(np.asarray(pvec0)).requires_grad_(True)
    pos = ts.pos.clone().requires_grad_(True)
    vel = ts.vel.clone().requires_grad_(True)
    pin_pos = None if not pinned else ts.pin_pos.clone().requires_grad_(True)
    p, v = pos, vel
    left = n
    while left:
        k = min(segment, left)
        p, v = cg._Segment.apply(p, v, pin_pos, prm, ts.pin_mask, k)
        left -= k
    if kind == "impact":                         # projected onto the sphere
        assert int((v.detach() == 0).all(0)[1:].sum()) > 0
    loss = (p * torch.tensor(wp)).sum() + (v * torch.tensor(wv)).sum()
    want = [prm, pos, vel] + ([pin_pos] if pinned else [])
    got = torch.autograd.grad(loss, want)
    for a, b in zip(got, ref):
        assert _max_rel(_np(a), b) < 1e-5
    if pinned:
        assert float(got[3].abs().max()) > 0


# ---------------------------------------------------------------------------
# (d) The public API: every ClothParams leaf, pos, vel and dt against
# jax.grad of the production XLA path, in the smooth regime
# ---------------------------------------------------------------------------

def test_multi_step_diff_matches_jax_xla_smooth(scene):
    jp, _, smooth, wp, wv = scene
    n = 24

    def jloss(pms, pos, vel, dt):
        out = jcloth.multi_step(smooth._replace(pos=pos, vel=vel), pms, dt, n)
        return jnp.sum(out.pos * wp) + jnp.sum(out.vel * wv)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(jp, smooth.pos, smooth.vel,
                                               JDT)
    ts = _to_torch(smooth)
    leaves = [a.requires_grad_(True)
              for a in tstate.params_from_numpy(jp, device="cpu")]
    pos = ts.pos.clone().requires_grad_(True)
    vel = ts.vel.clone().requires_grad_(True)
    dt = torch.tensor(DT, requires_grad=True)
    out = tcloth.multi_step_diff(ts._replace(pos=pos, vel=vel),
                                 tstate.ClothParams(*leaves), dt, n, segment=8)
    loss = (out.pos * torch.tensor(wp)).sum() + (out.vel * torch.tensor(wv)).sum()
    got = torch.autograd.grad(loss, leaves + [pos, vel, dt])
    names = list(tstate.ClothParams._fields) + ["pos", "vel", "dt"]
    for name, a, b in zip(names, got, list(ref[0]) + list(ref[1:])):
        a, b = _np(a), np.asarray(b, np.float64)
        if np.max(np.abs(b)) < 1e-6:
            assert np.max(np.abs(a)) < 1e-6, name
            continue
        assert _max_rel(a, b) < 2e-4, name


# ---------------------------------------------------------------------------
# (e) Against the JAX backward kernels themselves, in interpret mode:
# whole-plane (K7), banded (K8) and streamed (K9), pinned, with contact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,kw,n,segment", [
    ((12, 16), {}, 6, 3),
    ((12, 16), {"band": 8}, 6, 3),
    ((40, 16), {"stream": True}, 8, 8),
])
def test_multi_step_diff_matches_pallas_backward(hw, kw, n, segment):
    h, w = hw
    jp, js = _off_edge(h, w, "bounce", seed=6)
    js = _pinned(js)
    wp = np.random.default_rng(7).standard_normal((3, h, w)).astype(np.float32)

    def jloss(pos, vel, pp, pms):
        out = jcpg.multi_step(js._replace(pos=pos, vel=vel, pin_pos=pp), pms,
                              JDT, n, segment=segment, interpret=True, **kw)
        return jnp.sum(out.pos * wp)

    ref = jax.grad(jloss, argnums=(0, 1, 2, 3))(js.pos, js.vel, js.pin_pos, jp)
    ts = _to_torch(js)
    leaves = [a.requires_grad_(True)
              for a in tstate.params_from_numpy(jp, device="cpu")]
    pos, vel, pp = (a.clone().requires_grad_(True)
                    for a in (ts.pos, ts.vel, ts.pin_pos))
    out = tcloth.multi_step_diff(ts._replace(pos=pos, vel=vel, pin_pos=pp),
                                 tstate.ClothParams(*leaves), DT, n,
                                 segment=segment)
    got = torch.autograd.grad((out.pos * torch.tensor(wp)).sum(),
                              [pos, vel, pp] + leaves)
    for a, b in zip(got[:3], ref[:3]):
        assert _max_rel(_np(a), b) < 1e-4
    for name, a, b in zip(tstate.ClothParams._fields, got[3:], ref[3]):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# (f) The primal is the stepper's, bit for bit, whatever the segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("segment", [None, 8, 10, 24, 50])
@pytest.mark.parametrize("pinned", [False, True])
def test_primal_bitwise_and_trace(scene, segment, pinned):
    jp, contact, _, _, _ = scene
    ts = _to_torch(_pinned(contact) if pinned else contact)
    tp = tstate.params_from_numpy(jp, device="cpu")
    ref = cloth_kernel.multi_step(ts, tp, DT, 24)
    got = tcloth.multi_step_diff(ts, tp, DT, 24, segment=segment)
    assert torch.equal(got.pos, ref.pos) and torch.equal(got.vel, ref.vel)
    traj = cloth_kernel.trace(ts, cloth_kernel._pack_params(tp, DT), 25)
    assert torch.equal(traj[24], torch.cat([ref.pos, ref.vel]))
    assert torch.equal(traj[0], torch.cat([ts.pos, ts.vel]))


# ---------------------------------------------------------------------------
# (g) The example's inverse problem: one Newton step lands the target
# ---------------------------------------------------------------------------

def test_newton_step_recovers_gravity(scene):
    """The COM height after free fall is linear in gravity, so one Newton
    step from the gradient must land the target (a gradient wrong by 1%
    leaves a visible residual)."""
    jp, _, _, _, _ = scene
    c = jcfg.ClothConfig(height=H, width=W)
    s0 = _to_torch(jstate.init_cloth_state(c))
    base = tstate.params_from_numpy(jp, device="cpu")

    def rollout(g):
        out = tcloth.multi_step_diff(s0, base._replace(gravity=g), DT, 240,
                                     segment=48)
        return out.pos[1].mean()

    g0 = torch.tensor(-9.81, requires_grad=True)
    y0 = rollout(g0)
    (dy,) = torch.autograd.grad(y0, g0)
    g_star = g0.detach() - (y0.detach() - 36.0) / dy
    assert abs(float(rollout(g_star)) - 36.0) < 1e-3


def test_example_fit_kernel_path_matches_checkpointed():
    """The example's two routes (multi_step_diff, and autograd through the
    stencil twin with per-substep checkpointing) give the same descent."""
    a = differentiable_cloth.fit_gravity(8, "cpu", True, n_substeps=48,
                                         iters=3, segment=10)
    b = differentiable_cloth.fit_gravity(8, "cpu", False, n_substeps=48,
                                         iters=3)
    assert a[-1][0] < a[0][0]
    np.testing.assert_allclose(np.array(a), np.array(b), rtol=1e-4)


# ---------------------------------------------------------------------------
# (h) Dispatch: CPU → the plain versions; other devices raise
# ---------------------------------------------------------------------------

def test_dispatch_cpu_plain_and_other_devices_raise(scene):
    jp, contact, _, wp, wv = scene
    ts = _to_torch(contact)
    tp = tstate.params_from_numpy(jp, device="cpu")
    prm = cloth_kernel._pack_params(tp, DT)
    planes = torch.cat([ts.pos, ts.vel])
    cp, cv = torch.tensor(wp), torch.tensor(wv)
    k0, g0 = cloth_kernel.LAUNCHES, cg.LAUNCHES
    got = cg.substep_vjp(planes, cp, cv, prm)
    ref = cg.substep_vjp_plain(planes, cp, cv, prm)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], ref[:3]))
    pos = ts.pos.clone().requires_grad_(True)
    out = tcloth.multi_step_diff(ts._replace(pos=pos), tp, DT, 5, segment=2)
    out.pos.sum().backward()
    assert (cloth_kernel.LAUNCHES, cg.LAUNCHES) == (k0, g0)
    assert tcloth.multi_step_diff(ts, tp, DT, 0) is ts
    meta = planes.to("meta")
    with pytest.raises(ValueError, match="device"):
        cg.substep_vjp(meta, cp.to("meta"), cv.to("meta"), prm)
    with pytest.raises(ValueError, match="device"):
        cg.walk(meta[None], cp.to("meta"), cv.to("meta"), prm)
    with pytest.raises(ValueError, match="device"):
        cloth_kernel.trace(ts._replace(pos=ts.pos.to("meta")), prm, 2)
    with pytest.raises(ValueError, match="device"):
        tcloth.multi_step_diff(ts._replace(pos=ts.pos.to("meta")), tp, DT, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cg.substep_vjp_kernel(planes, cp, cv, prm)
    with pytest.raises(ValueError, match="one world"):
        batch = ts._replace(pos=ts.pos[None], vel=ts.vel[None])
        tcloth.multi_step_diff(batch, tp, DT, 4)
    with pytest.raises(ValueError, match="segment"):
        tcloth.multi_step_diff(ts, tp, DT, 4, segment=0)
