"""The batched row windows of the rows path on the CPU: the plain versions
of K1w, its trace and the window adjoint on a batch of windows of one
shape (each with its own first global row and pins), and the rows path's
one window call a device and exchange block.

Tolerances, with their reasons:

* the batched stepper, trace and walk against the same calls a window at
  a time: bit for bit (every op of the stepper and of the adjoint's state
  and pin cotangents is elementwise), the parameter cotangent excepted:
  the batch's is one float64 sum over all windows rounded once, the
  per-window route's a float32 sum of per-window roundings, so the two
  are held within 1e-6 of the largest |g|;
* the kernel-order parameter sum against a thread-by-thread mirror of the
  kernel's loops: bit for bit (both add the same float64 terms in the same
  order); against a plain float64 sum: 1e-12 relative (float64 rounding
  of terms of one sign).
"""

import numpy as np
import pytest
import torch

from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.core import state as tstate
from wgpu_physics_engine_torch.examples import multichip_training as mt
from wgpu_physics_engine_torch.ops import cloth_grad_kernel as cg
from wgpu_physics_engine_torch.ops import cloth_kernel

K = 2                                     # substeps a window call
HALO = 2 * K


def _window_of(x, lo, hi, h):
    """Rows [lo, hi) of ``x`` [..., h, W], zero beyond the grid."""
    out = torch.zeros(x.shape[:-2] + (hi - lo, x.shape[-1]), dtype=x.dtype)
    a, b = max(lo, 0), min(hi, h)
    out[..., a - lo:b - lo, :] = x[..., a:b, :]
    return out


def _batch(h, w, n_shards, pins):
    """Two worlds of an ``h × w`` cloth (noise on the positions, random
    velocities, part of it inside the globe's contact distance) cut into
    ``n_shards`` halo-extended windows each: top, middle and bottom
    windows of both worlds. With ``pins`` the second world's top row is
    pinned and the first world's windows get a zero mask. Returns the
    windows' pos, vel, pin mask, pin pos, first rows and packed params."""
    c = tcfg.ClothConfig(height=h, width=w, cloth_size=3.0,
                         center=(0.0, 10.05, 0.0))
    s = tstate.init_cloth_state(c, device="cpu")
    rng = np.random.default_rng(h * w)
    pos = torch.stack([s.pos] * 2) + torch.tensor(
        0.01 * rng.standard_normal((2, 3, h, w)), dtype=torch.float32)
    vel = torch.tensor(rng.standard_normal((2, 3, h, w)),
                       dtype=torch.float32)
    mask = torch.zeros((2, h, w), dtype=torch.bool)
    if pins:
        mask[1, 0] = True
    h_local = h // n_shards
    rows = h_local + 2 * HALO
    row0 = [i * h_local - HALO for _ in range(2) for i in range(n_shards)]
    win = [torch.stack([_window_of(x[j], r, r + rows, h)
                        for j in range(2)
                        for r in row0[:n_shards]])
           for x in (pos, vel, mask, pos)]
    prm = cloth_kernel._pack_params(
        tstate.ClothParams.from_config(c, device="cpu"), mt.DT)
    if not pins:
        win[2] = win[3] = None
    return win, row0, prm


def _one(x, b):
    return None if x is None else x[b]


# (h, w, shards): the example's 16² on 2 shards, and 24 × 32 on 3 (a
# middle window too)
SHAPES = [(16, 16, 2), (24, 32, 3)]


@pytest.mark.parametrize("pins", [False, True])
@pytest.mark.parametrize("h,w,n_shards", SHAPES)
def test_batched_plain_stepper_and_trace_equal_each_window(h, w, n_shards,
                                                           pins):
    """``multi_step_window_packed`` and ``trace_window`` on the batch equal
    the same calls on each window alone bit for bit; a window with a zero
    pin mask equals the window without pins."""
    win, row0, prm = _batch(h, w, n_shards, pins)
    got = cloth_kernel.multi_step_window_packed(*win, prm, K, row0, h)
    traj = cloth_kernel.trace_window(*win, prm, K + 1, row0, h)
    assert traj.shape == (K + 1, len(row0), 6) + tuple(win[0].shape[-2:])
    assert torch.equal(traj[K, :, :3], got[0])
    assert torch.equal(traj[K, :, 3:], got[1])
    for b, r in enumerate(row0):
        one = [_one(x, b) for x in win]
        if pins and not bool(one[2].any()):
            one[2] = one[3] = None               # a zero mask: no pins
        ref = cloth_kernel.multi_step_window_packed(*one, prm, K, r, h)
        assert torch.equal(got[0][b], ref[0])
        assert torch.equal(got[1][b], ref[1])
        assert torch.equal(traj[:, b], cloth_kernel.trace_window(
            *one, prm, K + 1, r, h))


@pytest.mark.parametrize("pins", [False, True])
@pytest.mark.parametrize("h,w,n_shards", SHAPES)
def test_batched_plain_walk_equals_each_window(h, w, n_shards, pins):
    """``walk_window``'s plain version on the batch: each window's state
    and pin cotangents equal its walk alone bit for bit, and the batch's
    one parameter cotangent is the sum of the windows' within 1e-6 of
    its largest entry."""
    win, row0, prm = _batch(h, w, n_shards, pins)
    traj = cloth_kernel.trace_window(*win, prm, K, row0, h)
    rng = np.random.default_rng(3)
    cp, cv = (torch.tensor(rng.standard_normal(win[0].shape),
                           dtype=torch.float32) for _ in range(2))
    pins_b = None if win[2] is None else (win[2], win[3])
    got = cg.walk_window(traj, cp, cv, prm, row0, h, pins_b)
    g_sum = torch.zeros(16, dtype=torch.float64)
    for b, r in enumerate(row0):
        pins_1 = None if pins_b is None else (win[2][b], win[3][b])
        ref = cg.walk_window(traj[:, b], cp[b], cv[b], prm, r, h, pins_1)
        assert torch.equal(got[0][b], ref[0])
        assert torch.equal(got[1][b], ref[1])
        if pins:
            assert torch.equal(got[3][b], ref[3])
        g_sum += ref[2].double()
    assert bool(torch.isfinite(got[2]).all())
    g_sum = g_sum.float()
    assert float((got[2] - g_sum).abs().max()) <= 1e-6 * float(
        g_sum.abs().max())
    if pins:
        assert float(got[3][len(row0) // 2:].abs().max()) > 0
        assert not bool(got[3][:len(row0) // 2].any())


def _mirror_partials(terms, tile=(16, 16), threads=256):
    """``csrc/cloth_grad.cu``'s partials of one window's substep, thread
    by thread: each thread's float64 sums over its cells (step 1b) and
    anchors (step 2a) in loop order, then the warp tree and the warps in
    order (``block_sum``)."""
    th, tw = tile
    h, w = terms.shape[-2:]
    t = terms.double().numpy()
    rows = []

    def block(v):
        out = []
        for warp in range(threads // 32):
            lane = list(v[warp * 32:(warp + 1) * 32])
            for off in (16, 8, 4, 2, 1):
                lane = [lane[i] + lane[i + off] for i in range(off)]
            out.append(lane[0])
        s = 0.0
        for x in out:
            s += x
        return s

    for ty in range(-(-h // th)):
        for tx in range(-(-w // tw)):
            r0, c0 = ty * th, tx * tw

            def cell(j, cols, y0, x0):
                y, x = j // cols - y0, j % cols - x0
                r, c = r0 + y, c0 + x
                ok = 0 <= y < th and 0 <= x < tw and r < h and c < w
                return (r, c) if ok else None

            gi = [[0.0] * threads for _ in range(7)]
            ge = [[0.0] * threads for _ in range(9)]
            n2, na = (th + 4) * (tw + 4), (th + 2) * (tw + 3)
            for i in range(threads):
                for j in range(i, n2, threads):
                    rc = cell(j, tw + 4, 2, 2)
                    if rc:
                        for m in range(7):
                            gi[m][i] += float(t[m][rc])
                for j in range(i, na, threads):
                    rc = cell(j, tw + 3, 2, 2)
                    if rc:
                        for f in range(6):
                            for m in range(3):
                                ge[3 * m + f // 2][i] += float(
                                    t[7 + 3 * f + m][rc])
            rows.append([block(v) for v in ge + gi])
    return torch.tensor(rows, dtype=torch.float64)


def test_kernel_order_partials_mirror_the_kernel():
    """``_kernel_order_partials`` equals a thread-by-thread mirror of the
    kernel's two loops and its block sum bit for bit on a window of two
    tiles across and a ragged second row of tiles, with dead rows; its
    rows add up to the plain float64 sums of the terms."""
    win, row0, prm = _batch(24, 32, 3, True)
    b = 0
    traj = cloth_kernel.trace_window(*[_one(x, b) for x in win], prm, 1,
                                     row0[b], 24)
    masks = cloth_kernel._window_masks(16, 32, row0[b], 24, "cpu")
    rng = np.random.default_rng(5)
    cp, cv = (torch.tensor(rng.standard_normal((3, 16, 32)),
                           dtype=torch.float32) for _ in range(2))
    _, _, terms, _ = cg._substep_vjp_planes(traj[0], cp, cv, prm,
                                            (win[2][b], win[3][b]), masks,
                                            terms=True)
    got = cg._kernel_order_partials(terms[:, None])
    assert torch.equal(got, _mirror_partials(terms))
    _, _, g, _ = cg._substep_vjp_planes(traj[0], cp, cv, prm,
                                        (win[2][b], win[3][b]), masks)
    np.testing.assert_allclose(got.sum(0).numpy(), g.numpy(), rtol=1e-12,
                               atol=1e-12 * float(g.abs().max()))


@pytest.mark.parametrize("grad", [False, True])
def test_rows_path_makes_one_window_call_a_block(monkeypatch, grad):
    """``batched_spatial_multi_step`` on the example's 8 CPU shards (a
    (4, 2) worlds × rows mesh of one device): one window call of all 16
    windows an exchange block, 8 for its 16 substeps; under autograd also
    one trace and one walk a block in the backward."""
    calls = {"step": [], "trace": [], "walk": []}

    def counted(key, fn, arg):
        def run(*args):
            calls[key].append(args[arg].shape[:-3])
            return fn(*args)
        return run

    monkeypatch.setattr(cloth_kernel, "multi_step_window_packed", counted(
        "step", cloth_kernel.multi_step_window_packed, 0))
    monkeypatch.setattr(cloth_kernel, "trace_window", counted(
        "trace", cloth_kernel.trace_window, 0))
    monkeypatch.setattr(cg, "walk_window", counted(
        "walk", cg.walk_window, 0))
    m, _, params, state = mt.make_problem(device="cpu")
    log_k = torch.log(params.k_struct).requires_grad_(grad)
    p = params._replace(k_struct=torch.exp(log_k))
    with torch.set_grad_enabled(grad):
        out = mt.rollout(state, p, m)
    blocks = mt.N_STEPS // mt.SUBSTEPS_PER_EXCHANGE
    assert calls["step"] == [(16,)] * blocks
    if grad:
        torch.autograd.grad(out.pos.sum(), log_k)
        assert calls["trace"] == [(16,)] * blocks
        assert calls["walk"] == [(mt.SUBSTEPS_PER_EXCHANGE, 16)] * blocks
    else:
        assert calls["trace"] == calls["walk"] == []
