"""Port parity, the broad phase and the kernel route's rebuild: the torch
``models/broadphase.py`` and the rebuild-time code of
``ops/granular_kernel.py`` against the JAX package on the CPU.

Inputs come from a seed through numpy. Every rebuild structure is integer
arithmetic on the same stable sort, so the sorted grid, the window ranges,
the candidate lists, the CIV intervals, the window table, the slab offsets
and both dropped counts must equal JAX's bit for bit. (The JAX package
pads to ``n_pad`` rows and to 16 groups and tiles the offsets in rows of
8; the port keeps the meaningful rows, which are compared.) The pair
forces are sums in another order: 1e-5 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.models import broadphase as jbp
from wgpu_physics_engine_tpu.ops import granular_pallas as jgp
from wgpu_physics_engine_torch.models import broadphase as tbp
from wgpu_physics_engine_torch.ops import granular_kernel as tgk

SPEC = dict(origin=(-2.0, -2.0, -2.0), cell_size=0.32, dims=(13, 13, 13),
            capacity=8)


def _pos(seed, n=1200, lo=-1.9, hi=1.9, clustered=False):
    rng = np.random.default_rng(seed)
    if clustered:
        # uneven columns: blocks straddle column boundaries and cid sets
        # have holes (the slab B and fast-indicator paths)
        p = np.concatenate([rng.uniform(lo, lo + 0.9 * (i + 1), (3, n // 3))
                            for i in range(3)], axis=1)
    else:
        p = rng.uniform(lo, hi, (3, n))
    v = rng.normal(size=p.shape)
    return p.astype(np.float32), v.astype(np.float32)


def _grids(p, v, spec_kw=SPEC, origin=None):
    js = jbp.GridSpec(**spec_kw)
    ts = tbp.GridSpec(**spec_kw)
    jo = None if origin is None else jnp.asarray(origin, jnp.float32)
    to = None if origin is None else torch.tensor(origin, dtype=torch.float32)
    jg = jbp.build_sorted_grid(jnp.asarray(p), jnp.asarray(v), js, jo)
    tg = tbp.build_sorted_grid(torch.tensor(p), torch.tensor(v), ts, to)
    return js, ts, jg, tg


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(b), a.numpy() if
                                  isinstance(a, torch.Tensor) else a)


@pytest.mark.parametrize("seed,origin", [(0, None), (1, (-2.1, -1.95, -2.05))])
def test_sorted_grid_bitwise(seed, origin):
    p, v = _pos(seed)
    js, ts, jg, tg = _grids(p, v, origin=origin)
    for f in jbp.SortedGrid._fields:
        a, b = getattr(tg, f), getattr(jg, f)
        assert a.dtype == getattr(torch, str(np.asarray(b).dtype))
        _eq(a, b)
    # cell_start is the searchsorted definition, with the two trailing n
    cells = np.arange(js.num_cells + 3)
    _eq(tg.cell_start, np.searchsorted(tg.sorted_cid.numpy(), cells, "left"))


def test_cell_ids_and_table_bitwise():
    p, _ = _pos(2, n=900, lo=-2.5, hi=2.5)          # some outside: clipped
    spec_kw = dict(SPEC, capacity=3)
    js, ts = jbp.GridSpec(**spec_kw), tbp.GridSpec(**spec_kw)
    _eq(tbp.cell_ids(torch.tensor(p), ts),
        jbp.cell_ids(jnp.asarray(p), js))
    tt, td = tbp.build_table(torch.tensor(p), ts, return_stats=True)
    jt, jd = jbp.build_table(jnp.asarray(p), js, return_stats=True)
    _eq(tt, jt)
    assert int(td) == int(jd) > 0                   # capacity 3 overflows


def test_group_window_ranges_bitwise():
    p, v = _pos(3)
    js, ts, jg, tg = _grids(p, v)
    c_t = tbp.cell_coords(tg.sorted_pos, ts)
    c_j = jnp.clip(jnp.floor((jg.sorted_pos - jnp.asarray(js.origin)[:, None])
                             / js.cell_size).astype(jnp.int32), 0,
                   jnp.asarray(js.dims)[:, None] - 1)
    _eq(c_t, c_j)
    for a, b in zip(tbp.group_window_ranges(c_t, ts, tg.cell_start),
                    jbp.group_window_ranges(c_j, js, jg.cell_start)):
        _eq(a, b)


@pytest.mark.parametrize("window,max_nb", [(32, 48), (8, 12)])
def test_build_candidates_bitwise(window, max_nb):
    """The argmin-extraction compaction, including truncation (the second
    case drops candidates to both ``window`` and ``max_neighbors``)."""
    p, v = _pos(4, n=1500, lo=-1.2, hi=1.2)
    js, ts, jg, tg = _grids(p, v)
    ti, tm, td = tbp.build_candidates(tg, ts, 0.3, window, max_nb)
    ji, jm, jd = jbp.build_candidates(jg, js, 0.3, window, max_nb)
    _eq(ti, ji)
    _eq(tm, jm)
    assert int(td) == int(jd)
    assert (int(td) > 0) == (window == 8)


def test_pair_forces_match_jax():
    p, v = _pos(5, n=800, lo=-1.5, hi=1.5)
    js, ts, jg, tg = _grids(p, v)
    tf, td = tbp.pair_forces_sorted(tg, ts, 0.12, 500.0, window=16,
                                    return_stats=True)
    jf, jd = jbp.pair_forces_sorted(jg, js, 0.12, 500.0, window=16,
                                    return_stats=True)
    assert int(td) == int(jd)
    assert float(np.abs(np.asarray(jf)).max()) > 1.0       # contacts exist
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(jf)).max()))
    tt = tbp.build_table(torch.tensor(p), ts)
    jt = jbp.build_table(jnp.asarray(p), js)
    tf = tbp.pair_forces(torch.tensor(p), torch.tensor(v), tt, ts, 0.12, 500.0)
    jf = jbp.pair_forces(jnp.asarray(p), jnp.asarray(v), jt, js, 0.12, 500.0)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(jf)).max()))


@pytest.mark.parametrize("thin", [False, True])
def test_civ_bounds_equal(thin):
    assert (tgk.civ_bounds(tbp.GridSpec(**SPEC), thin)
            == jgp.civ_bounds(jbp.GridSpec(**SPEC), thin))


def _nb_pad(n, block, slab):
    n_pad = -(-max(n, slab) // block) * block
    return n_pad, n_pad // block


@pytest.mark.parametrize("block,slab,thin,clustered", [
    (128, 512, False, False), (128, 128, False, True),
    (128, 256, True, True), (64, 384, True, False)])
def test_build_windows_bitwise(block, slab, thin, clustered):
    p, v = _pos(6, clustered=clustered)
    js, ts, jg, tg = _grids(p, v)
    n = p.shape[1]
    n_pad, nb = _nb_pad(n, block, slab)
    ng, ngp = (3, 4) if thin else (9, 16)
    jw, joff, jd = jgp.build_windows(jg, js, block, slab, n_pad, thin=thin)
    slabs, td = tgk.build_windows(tg, ts, block, slab, n_pad, thin=thin)
    jw = np.asarray(jw)
    _eq(slabs.windows[0], jw[:n, :ng])
    _eq(slabs.windows[1], jw[:n, ngp:ngp + ng])
    _eq(slabs.off, np.asarray(joff)[:nb].reshape(nb, ng, 2))
    assert int(td) == int(jd)
    if slab == 128:
        assert int(td) > 0


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("block,slab,thin", [
    (128, 512, False), (128, 128, False), (128, 128, True), (128, 384, True),
    (256, 256, False)])
def test_build_offsets_civ_bitwise(block, slab, thin, stats):
    """Slab offsets, the cid plane and the dropped count (exact with
    ``stats``, the sound fast indicator without) over clustered piles."""
    hits = 0
    for seed in (7, 8):
        p, v = _pos(seed, n=1500, clustered=True)
        js, ts, jg, tg = _grids(p, v, spec_kw=dict(
            origin=(-2.0,) * 3, cell_size=0.25, dims=(16, 16, 16)))
        n = p.shape[1]
        n_pad, nb = _nb_pad(n, block, slab)
        ng = 3 if thin else 9
        jc, joff, jd = jgp.build_offsets_civ(jg, js, block, slab, n_pad,
                                             thin=thin, stats=stats)
        slabs, td = tgk.build_offsets_civ(tg, ts, block, slab, n_pad,
                                          thin=thin, stats=stats)
        _eq(slabs.off, np.asarray(joff)[:nb].reshape(nb, ng, 2))
        _eq(slabs.cid, np.asarray(jc)[:n].astype(np.int32))
        assert slabs.bounds == jgp.civ_bounds(js, thin)
        assert int(td) == int(jd)
        hits += int(td) > 0
    if slab == 128:
        assert hits > 0                      # the sweep exercises drops


@pytest.mark.parametrize("cids,exact_pos", [
    ([90] * 60 + [100] * 8 + [130] * 60
     + [361] * 128 + [362] * 128 + [375] * 128 + [401] * 128, True),
    ([100] * 60 + [110] * 8 + [130] * 60
     + [371] * 128 + [375] * 128 + [384] * 128 + [401] * 128, False)])
def test_civ_fast_indicator_cases(cids, exact_pos):
    """The reference's two hand-built cases (tests/test_granular_pallas.py):
    a masked gap drop the fast indicator must see, and the documented
    phantom over-report (fast > 0 with nothing dropped), ported as it is."""
    spec_kw = dict(origin=(0.0,) * 3, cell_size=1.0, dims=(16, 16, 16))
    cids = np.asarray(sorted(cids))
    p = (np.stack([cids // 256, (cids % 256) // 16, cids % 16])
         .astype(np.float32) + 0.5)
    js, ts, jg, tg = _grids(p, np.zeros_like(p), spec_kw=spec_kw)
    n_pad = -(-max(p.shape[1], 128) // 128) * 128
    got = {}
    for stats in (False, True):
        _, td = tgk.build_offsets_civ(tg, ts, 128, 128, n_pad, stats=stats)
        _, _, jd = jgp.build_offsets_civ(jg, js, 128, 128, n_pad, stats=stats)
        assert int(td) == int(jd)
        got[stats] = int(td)
    assert got[False] > 0
    assert (got[True] > 0) == exact_pos


def test_civ_windows_equal_window_table():
    """CIV's windows (from cid and cell_start) contain the window table's
    nonempty windows away from the borders: the same candidate sets."""
    p, v = _pos(9, lo=-1.2, hi=1.2)
    js, ts, jg, tg = _grids(p, v)
    n = p.shape[1]
    n_pad, _ = _nb_pad(n, 128, 512)
    civ, _ = tgk.build_offsets_civ(tg, ts, 128, 512, n_pad)
    win, _ = tgk.build_windows(tg, ts, 128, 512, n_pad)
    cs, ce = tgk.group_windows(civ)
    ws, we = tgk.group_windows(win)
    nonempty = we > ws
    assert bool(nonempty.any())
    assert torch.equal(cs[nonempty], ws[nonempty])
    assert torch.equal(ce[nonempty], we[nonempty])
