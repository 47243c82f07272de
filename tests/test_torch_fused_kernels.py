"""The design of the granular substep's direct walk (K10 on the full
candidate set), on the CPU, as a mirror of the kernel's schedule in torch.

K10 on the full set reads each slot's candidates directly (no staging):
per group, the window inside slab A and then inside slab B, each summed in
double over its slots in order and rounded once, added to the A and the B
total in group order, then A + B and the integrate. The mirror equals
``substep_sorted_plain`` bit for bit on a small pile on the full and the
thin set, with an undersized slab that drops window entries, and as K10b
on a slice of the slots (``base``, ``n_local``); on the thin set, which
stays staged, every slot's candidates lie inside the span its CTA stages
(the first slot's window start to the last slot's window end, each slab).

The plain version is held to the JAX package in ``test_torch_granular.py``;
inputs here come from numpy seeds.
"""

import numpy as np
import pytest
import torch

from wgpu_physics_engine_torch.models import granular as tgr
from wgpu_physics_engine_torch.ops import granular_kernel as gk

# ---------------------------------------------------------------------------
# K10: the direct walk on the full set, the staged span on the thin set
# ---------------------------------------------------------------------------

PILE = dict(num_particles=1500, bounds=2.0, radius=0.08, restitution=0.4,
            rebuild_every=4, pallas_block=128)


def _pile(seed, **kw):
    """A compressed lattice (vertical neighbours overlap) with numpy
    jitter and velocities, and its frozen candidate set."""
    cfg = tgr.GranularConfig(**{**PILE, **kw})
    st = tgr.init_state(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    rng = np.random.default_rng(seed)
    vel = torch.tensor(rng.standard_normal(st.vel.shape).astype(np.float32))
    grid, slabs, dropped = tgr.rebuild(st.pos, vel, cfg, stats=True)
    prm = gk.kernel_params(cfg, 1.0 / 240.0, "cpu")
    return grid.sorted_pos, grid.sorted_vel, slabs, prm, int(dropped)


def _direct_walk(pos, vel, prm, slabs, base=0, n_local=None):
    """K10's direct walk in torch, vectorized over the slots ``[base, base
    + n_local)``: group by group, slab A's then slab B's candidates of the
    slot's window read from the full array at their global slots, each
    range summed in double in slot order and rounded once into the float
    total of its slab; f = A + B; then the integrate."""
    n = pos.shape[1]
    nl = n - base if n_local is None else n_local
    md, kc = prm[0], prm[1]
    p = pos[:, base:base + nl]
    totals = [torch.zeros((3, nl)), torch.zeros((3, nl))]
    ranges = gk.slab_ranges(slabs, nl, base)
    for g in range(slabs.ng):
        for half, (lo, hi) in enumerate(ranges):
            acc = torch.zeros((3, nl), dtype=torch.float64)
            width = int(torch.clamp_min(hi[:, g] - lo[:, g], 0).max())
            for m in range(width):
                j = lo[:, g] + m
                valid = j < hi[:, g]
                jj = torch.clamp(j, 0, n - 1)
                ds = [p[e] - pos[e][jj] for e in range(3)]
                d2 = ds[0] * ds[0] + ds[1] * ds[1] + ds[2] * ds[2]
                touching = valid & (d2 < md * md) & (d2 > 1e-12)
                inv = 1.0 / torch.sqrt(torch.where(touching, d2, 1.0))
                wgt = kc * (md * inv - 1.0)
                for e in range(3):
                    acc[e] += torch.where(touching, wgt * ds[e], 0.0).double()
            totals[half] += acc.float()
    return gk._integrate(p, vel, totals[0] + totals[1], prm)


@pytest.mark.parametrize("kw,undersized", [
    (dict(pallas_slab=512), False),                    # full set
    (dict(pallas_slab=128), True),                     # slab drops entries
    (dict(pallas_slab=512, thin=True), False),         # thin set
    (dict(pallas_slab=128, thin=True), True),
])
def test_direct_walk_equals_plain(kw, undersized):
    pos, vel, slabs, prm, dropped = _pile(11, **kw)
    assert (dropped > 0) == undersized
    ref = gk.substep_sorted_plain(pos, vel, prm, slabs)
    got = _direct_walk(pos, vel, prm, slabs)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert float((ref[1] - vel).abs().max()) > 1e-3     # contacts ran
    n = pos.shape[1]
    block = slabs.block
    base, nl = block, n - 3 * block                     # K10b: a slice
    ref_b = gk.substep_sorted_plain(pos, vel[:, base:base + nl], prm, slabs,
                                    base, nl)
    got_b = _direct_walk(pos, vel[:, base:base + nl], prm, slabs, base, nl)
    assert torch.equal(got_b[0], ref_b[0]) and torch.equal(got_b[1], ref_b[1])
    n_lanes, cta, stage = gk.walk_geometry(slabs, n, 132 * 2048)
    assert stage == (slabs.ng <= 3) and block % cta == 0


@pytest.mark.parametrize("slab", [512, 128])
def test_thin_set_stays_inside_the_staged_span(slab):
    """The staged walk reads a slot's candidates from the span its CTA
    stages: the first live slot's window start to the last's window end,
    clipped to each slab (``granular_step.cu`` ``contact_force``)."""
    pos, _, slabs, _, _ = _pile(12, pallas_slab=slab, thin=True)
    n = pos.shape[1]
    # a card that holds these slots once: one lane, as the 1M thin pile
    n_lanes, cta, stage = gk.walk_geometry(slabs, n, n)
    assert stage and n_lanes == 1 and cta == slabs.block
    s, e = gk.group_windows(slabs)
    (a_lo, a_hi), (b_lo, b_hi) = gk.slab_ranges(slabs, n)
    for t0 in range(0, n, cta):
        t1 = min(n, t0 + cta)
        blk = t0 // slabs.block
        oa = slabs.off[blk, :, 0].long()
        ob = slabs.off[blk, :, 1].long()
        span_a = (torch.maximum(s[t0], oa),
                  torch.minimum(e[t1 - 1], oa + slabs.slab))
        span_b_lo = torch.maximum(s[t0], torch.maximum(ob, oa + slabs.slab))
        span_b = (span_b_lo, torch.where(
            ob > oa, torch.minimum(e[t1 - 1], ob + slabs.slab), span_b_lo))
        for (lo, hi), (slo, shi) in (((a_lo, a_hi), span_a),
                                     ((b_lo, b_hi), span_b)):
            live = hi[t0:t1] > lo[t0:t1]
            assert bool(((lo[t0:t1] >= slo) | ~live).all())
            assert bool(((hi[t0:t1] <= shi) | ~live).all())
