#!/usr/bin/env python3
"""Times of the contact pair-force walk (K10, K11, K12, K10b), the cloth
kernels (K1, its trace, K5, K1w, K6w, K1f, K6), the cloth adjoint (K7-K9)
and the tile-binned sphere raster (K2/K3) at their main-path shapes on one
CUDA card, for comparing two checkouts of the repo on one machine.

    python3 tools/kernel_ab.py [--root DIR] [--sweep] [--check]
           [--only PART [PART ...]]

Imports ``wgpu_physics_engine_torch`` from ``DIR`` (default: this
checkout), builds its kernels from that checkout's sources, and prints one
JSON line with the card's name and power limit and, in ms a launch (CUDA
events over back-to-back launches, best of 5):

* ``k11_sc``: K11 on the self-collision candidate set of the 256² cloth
  of ``ClothScene(self_collide=True)`` after ``simulate(2.0)`` (thin CIV,
  block 256, the scene's slab 1024), ``k11_sc_flat`` on the fresh flat
  sheet's set; ``k11_1m``, ``k12_1m``, ``k10_1m``: at 1M on the fresh
  lattice in the default configuration; ``k10_thin_1m``: the bench
  configuration (thin CIV, slab 640); ``k10b_1m``: K10b on the second
  quarter of the default pile's slots (the grain-sharded shard body);
* ``k1_flagship_8`` and ``k1_flagship_240``: K1 at 256² on the flagship's
  draped state (``ClothScene.simulate(5.0)``), ms a substep, calls of 8
  substeps (the scene's frame) and of 240; ``k1_trace``: the training
  segment's trace, 48 substeps at 256², ms a substep; ``k1_60_8`` and
  ``k1_60_240``: the reference 60×60 cloth draped 3 s; ``k6_1000x1030``:
  ``cloth_kernel.multi_step`` at 1000×1030 (above 100,000 particles: K6),
  48 substeps, ms a substep; ``k5_1024``: K5, one substep on 1,024 worlds
  of the 60×60 cloth (the datagen chunk); ``k1f_256``: K1f at 256², a
  call of one launch;
* part ``window``: ``k1w_rows``: K1w a substep on
  one shard's 260×1024 window of the 1024² cloth, ``k1w_composed`` on a
  composed shard's 136×256 window (240 substeps a call, as the kernel's
  launch time; the paths call it 1 or 2 at a time); ``k6w_composed``:
  K6w on the composed window, timed in turns with K1w there (K1w, K6w,
  K6w, K1w, ``TURNS`` rounds, each time in ``composed_turns``, where the
  checkout has K6w); ``k6w_rows`` and
  ``k6w_rows_2``: ``cloth_kernel.multi_step_window``, the routed call, on
  the rows shard's window (above 100,000 particles: K6w where the checkout
  has it, else K1w), 240 substeps a call and a call of 2 (the path's);
  ``rows_1024_k1_psteps`` and ``rows_1024_k2_psteps``: the rows path end
  to end, ``spatial_multi_step`` of the 1024² cloth on 4 row shards of the
  card, 96 substeps at k = 1 and 2, particle-steps/s by host clock;
* ``adj_256``: ``cloth_grad_kernel.walk`` over the training segment's
  trace, 48 substeps of the fresh 256² cloth, ms a substep (the walk's
  reduction included), and ``adj_256_device_us``, its device time by
  kernel from a ``torch.profiler`` trace (other tiles and the phases of a
  CTA: ``tools/adjoint_probe.py``);
* ``raster_flagship``: the 256×256 frame of the 256² flagship after
  ``simulate(5.0)``, 65,536 instances; ``raster_datagen``: one call on a
  chunk of 1,024 worlds of the 60×60 cloth settled 3 s, randomized
  cameras, 256×256; ``raster_granular``: the 256×256 frame of the 1M
  ``GranularScene`` after ``simulate(1.0)``;
* with ``--sweep`` (a checkout with K6w) K6w on the rows window over tile
  heights and widths at k = 1; (a checkout whose walk has
  ``walk_geometry``), K11 and
  K10-thin over lanes and CTA sizes; (a checkout whose walk has
  ``staged``) K10, K11 and K12 at 1M, K10-thin and K11 on the
  self-collision set over the staged and the direct walk; and (a checkout
  whose raster has a work list) the raster over chunk sizes;
* with ``--check``, each kernel against its plain version: the largest
  difference and whether they are equal bit for bit;
* with ``--only`` and one or more of ``walk``, ``cloth``, ``window``,
  ``adjoint`` and ``raster``, only those parts; with ``e2e`` among them, also the host-bound loops the
  walk runs in (``self_collide_256`` and the granular value_and_grad at
  1M, host clock, best of 5).

Compare two checkouts in turns (A, B, B, A) in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# rounds of (K1w, K6w, K6w, K1w) on the composed window
TURNS = 4


def _best_ms(fn, reps: int = 5, inner: int = 1) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / inner)
    return best


def _device_us(fn) -> dict:
    """Device time (µs) of one call of ``fn`` by kernel name, from a
    torch.profiler trace."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0][-48:]
            us[name] = us.get(name, 0.0) + e.device_time
    return us


def _best_s(fn, reps: int = 5) -> float:
    """Host clock (s) of ``fn`` ending in a synchronize: the best of
    ``reps`` after a warm-up call."""
    import torch

    best = float("inf")
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            best = min(best, time.perf_counter() - t0)
    return best


def _e2e(out, dev, c256, configs):
    """The host-bound loops the walk runs in, particle-steps/s by host
    clock: ``self_collide_256`` (bench.py:185-220: 256², 512 substeps,
    rebuild every 32, slab 640, skin 0.5 r) and the granular
    value_and_grad at 1M (16 substeps of ``granular.multi_step_diff`` on
    the lattice lowered to the floor, a linear loss of pos and vel)."""
    import numpy as np
    import torch

    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      ParticleState,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.models import cloth, granular

    params = ClothParams.from_config(c256, device=dev)
    spec = cloth.default_self_collision_grid(
        c256, skin=0.5 * c256.particle_radius)
    s0 = init_cloth_state(c256, device=dev)
    s = _best_s(lambda: cloth.multi_step_self_collide(
        s0, params, 1.0 / 480.0, 512, spec, rebuild_every=32,
        pallas_slab=640))
    out["self_collide_256_psteps"] = 256 * 256 * 512 / s

    cfg = configs["default"]
    st = granular.init_state(cfg, torch.Generator().manual_seed(0),
                             device=dev)
    pos = st.pos.clone()
    pos[1] += (0.02 - (cfg.bounds - cfg.radius)) - float(pos[1].min())
    vel = torch.zeros_like(st.vel)
    vel[1] = -1.0
    n = pos.shape[1]
    rng = np.random.default_rng(16)
    wp, wv = (torch.tensor(rng.standard_normal((3, n)).astype(np.float32),
                           device=dev) for _ in range(2))

    def value_and_grad():
        leaves = [pos.clone(), vel.clone()] + [
            torch.tensor(v, dtype=torch.float32, device=dev)
            for v in (1.0 / 240.0, cfg.k_contact, cfg.gravity,
                      cfg.restitution)]
        for t in leaves:
            t.requires_grad_(True)
        o = granular.multi_step_diff(
            ParticleState(pos=leaves[0], vel=leaves[1]), cfg, leaves[2], 16,
            k_contact=leaves[3], gravity=leaves[4], restitution=leaves[5])
        loss = (o.pos * wp).sum() + (o.vel * wv).sum()
        torch.autograd.grad(loss, leaves)

    out["granular_value_and_grad_psteps"] = n * 16 / _best_s(value_and_grad)


def _equal(a, b):
    import torch

    a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
    diff = max(float((x.float() - y.float()).abs().nan_to_num(0.0).max())
               if x.numel() else 0.0 for x, y in zip(a, b))
    return {"max_abs": diff, "bitwise": all(torch.equal(x, y)
                                            for x, y in zip(a, b))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--only", nargs="+",
                    choices=("walk", "cloth", "window", "adjoint", "raster",
                             "e2e"))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.models import cloth, granular
    from wgpu_physics_engine_torch.ops import _build

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    for name in ("granular_step", "sphere_raster", "cloth_step",
                 "cloth_tiled", "cloth_grad"):
        _build.build(name)
    out = {"root": root, "card": card}
    checks = {}
    inner = 20

    # ---- the pair-force walk ----
    def sc_set(state, slab):
        h, w = state.pos.shape[-2:]
        c = ClothConfig(height=h, width=w)
        spec = cloth.default_self_collision_grid(
            c, skin=2.0 * c.particle_radius)
        n = h * w
        grid, slabs, dropped = cloth._frozen_structs(
            state.pos.reshape(3, n), state.vel.reshape(3, n), spec, 256, slab,
            stats=True)
        return grid.sorted_pos, slabs, 2.0 * c.particle_radius, c.k_contact

    c256 = ClothConfig(height=256, width=256)
    configs = {"default": granular.GranularConfig(num_particles=1_000_000),
               "thin": granular.GranularConfig(
                   num_particles=1_000_000, rebuild_every=16,
                   pallas_slab=640, thin=True)}
    parts = (("walk", "cloth", "window", "adjoint", "raster")
             if args.only is None else args.only)
    if "walk" in parts:
        _walk(args, out, checks, inner, dev, c256, configs, sc_set)
    if "cloth" in parts:
        _cloth(args, out, checks, inner, dev, c256)
    if "window" in parts:
        _window(args, out, checks, inner, dev, c256)
    if "adjoint" in parts:
        _adjoint(args, out, checks, dev, c256)
    if "raster" in parts:
        _raster(args, out, checks, dev, c256, configs)
    if "e2e" in parts:
        _e2e(out, dev, c256, configs)
    if args.check:
        out["checks"] = checks
    print(json.dumps(out))
    return 0


def _walk(args, out, checks, inner, dev, c256, configs, sc_set):
    """The pair-force walk's timings (and checks and sweep)."""
    import torch

    from wgpu_physics_engine_torch.core.state import init_cloth_state
    from wgpu_physics_engine_torch.models import granular, scenes
    from wgpu_physics_engine_torch.ops import granular_kernel as gk

    scene = scenes.ClothScene(c256, self_collide=True, device=dev)
    scene.simulate(2.0)
    sets = {"k11_sc": sc_set(scene.state, scenes.SELF_COLLIDE_SLAB),
            "k11_sc_flat": sc_set(init_cloth_state(c256, device=dev),
                                  scenes.SELF_COLLIDE_SLAB)}
    for key, (p, slabs, md, kc) in sets.items():
        out[key] = _best_ms(lambda: gk.contact_forces_sorted_kernel(
            p, md, kc, slabs), inner=inner)
        out[key + "_candidates"] = gk.candidate_count(slabs, p.shape[1])
        if args.check:
            checks[key] = _equal(
                gk.contact_forces_sorted_kernel(p, md, kc, slabs),
                gk.contact_forces_sorted_plain(p, md, kc, slabs))
            u = torch.randn(p.shape,
                            generator=torch.Generator().manual_seed(7)).to(dev)
            checks[key + "_jvp"] = _equal(
                gk.contact_force_jvp_sorted_kernel(p, u, md, kc, slabs),
                gk.contact_force_jvp_sorted_plain(p, u, md, kc, slabs))

    gsets = {}
    for name, cfg in configs.items():
        st = granular.init_state(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
        grid, slabs, _ = granular.rebuild(st.pos, st.vel, cfg)
        prm = gk.kernel_params(cfg, 1.0 / 240.0, dev)
        gsets[name] = (grid.sorted_pos, grid.sorted_vel, slabs, prm)
    p, v, slabs, prm = gsets["default"]
    u = torch.randn(p.shape,
                    generator=torch.Generator().manual_seed(6)).to(dev)
    out["k11_1m"] = _best_ms(lambda: gk.contact_forces_sorted_kernel(
        p, prm[0], prm[1], slabs), inner=inner)
    out["k12_1m"] = _best_ms(lambda: gk.contact_force_jvp_sorted_kernel(
        p, u, prm[0], prm[1], slabs), inner=inner)
    out["k10_1m"] = _best_ms(lambda: gk.substep_sorted_kernel(
        p, v, prm, slabs), inner=inner)
    pt, vt, slabs_t, prm_t = gsets["thin"]
    out["k10_thin_1m"] = _best_ms(lambda: gk.substep_sorted_kernel(
        pt, vt, prm_t, slabs_t), inner=inner)
    q = p.shape[1] // 4 // slabs.block * slabs.block
    vq = v[:, q:2 * q].contiguous()
    out["k10b_1m"] = _best_ms(lambda: gk.substep_sorted_kernel(
        p, vq, prm, slabs, q, q), inner=inner)
    if args.check:
        checks["k11_1m"] = _equal(
            gk.contact_forces_sorted_kernel(p, prm[0], prm[1], slabs),
            gk.contact_forces_sorted_plain(p, prm[0], prm[1], slabs))
        checks["k10_1m"] = _equal(
            gk.substep_sorted_kernel(p, v, prm, slabs),
            gk.substep_sorted_plain(p, v, prm, slabs))
        checks["k10_thin_1m"] = _equal(
            gk.substep_sorted_kernel(pt, vt, prm_t, slabs_t),
            gk.substep_sorted_plain(pt, vt, prm_t, slabs_t))
        checks["k10b_1m"] = _equal(
            gk.substep_sorted_kernel(p, vq, prm, slabs, q, q),
            gk.substep_sorted_plain(p, vq, prm, slabs, q, q))
    if args.sweep and hasattr(gk, "walk_geometry"):
        saved = (gk.lanes, gk.CTA_THREADS)
        sweep = {}
        p_sc, s_sc, md, kc = sets["k11_sc"]
        ref = gk.contact_forces_sorted_plain(p_sc, md, kc, s_sc)
        ref_t = gk.substep_sorted_plain(pt, vt, prm_t, slabs_t)
        for n_lanes, threads in ((1, 256), (2, 256), (4, 256), (4, 512),
                                 (8, 256), (8, 512)):
            gk.lanes = (lambda slabs, n, resident, n_lanes=n_lanes:
                        n_lanes if slabs.ng <= 3 else 1)
            gk.CTA_THREADS = threads
            k = f"L{n_lanes}_T{threads}"
            if args.check:
                checks["k11_sc_" + k] = _equal(
                    gk.contact_forces_sorted_kernel(p_sc, md, kc, s_sc), ref)
                checks["k10_thin_1m_" + k] = _equal(
                    gk.substep_sorted_kernel(pt, vt, prm_t, slabs_t), ref_t)
            sweep["k11_sc_" + k] = _best_ms(
                lambda: gk.contact_forces_sorted_kernel(p_sc, md, kc, s_sc),
                inner=inner)
            sweep["k10_thin_1m_" + k] = _best_ms(
                lambda: gk.substep_sorted_kernel(pt, vt, prm_t, slabs_t),
                inner=inner)
        gk.lanes, gk.CTA_THREADS = saved
        out["walk_sweep"] = sweep
    if args.sweep and hasattr(gk, "staged"):
        saved = gk.staged
        sweep = {}
        p_sc, s_sc, md, kc = sets["k11_sc"]
        for stage in (True, False):
            gk.staged = lambda slabs, stage=stage: stage
            k = "staged" if stage else "direct"
            sweep["k10_1m_" + k] = _best_ms(lambda: gk.substep_sorted_kernel(
                p, v, prm, slabs), inner=inner)
            sweep["k11_1m_" + k] = _best_ms(
                lambda: gk.contact_forces_sorted_kernel(p, prm[0], prm[1],
                                                        slabs), inner=inner)
            sweep["k12_1m_" + k] = _best_ms(
                lambda: gk.contact_force_jvp_sorted_kernel(
                    p, u, prm[0], prm[1], slabs), inner=inner)
            sweep["k10_thin_1m_" + k] = _best_ms(
                lambda: gk.substep_sorted_kernel(pt, vt, prm_t, slabs_t),
                inner=inner)
            sweep["k11_sc_" + k] = _best_ms(
                lambda: gk.contact_forces_sorted_kernel(p_sc, md, kc, s_sc),
                inner=inner)
            if args.check:
                checks["k10_1m_" + k] = _equal(
                    gk.substep_sorted_kernel(p, v, prm, slabs),
                    gk.substep_sorted_plain(p, v, prm, slabs))
                checks["k11_sc_" + k] = _equal(
                    gk.contact_forces_sorted_kernel(p_sc, md, kc, s_sc),
                    gk.contact_forces_sorted_plain(p_sc, md, kc, s_sc))
        gk.staged = saved
        out["walk_stage_sweep"] = sweep
    del gsets, sets


def _cloth(args, out, checks, inner, dev, c256):
    """The cloth kernels' timings, ms a substep (and checks)."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.ops import cloth_kernel as ck
    from wgpu_physics_engine_torch.ops import cloth_tiled_kernel as ctk
    from wgpu_physics_engine_torch.parallel import datagen

    dt = 1.0 / 480.0

    def draped(c, n):
        p = ClothParams.from_config(c, device=dev)
        return ck.multi_step_kernel(init_cloth_state(c, device=dev), p, dt,
                                    n), p

    s256, p256 = draped(c256, 2400)
    c60 = ClothConfig()
    s60, p60 = draped(c60, 1440)
    prm256 = ck._pack_params(p256, dt)
    k1 = {"k1_flagship_8": (s256, p256, 8), "k1_flagship_240": (s256, p256,
                                                                 240),
          "k1_60_8": (s60, p60, 8), "k1_60_240": (s60, p60, 240)}
    for key, (s, p, n) in k1.items():
        out[key] = _best_ms(lambda: ck.multi_step_kernel(s, p, dt, n),
                            inner=max(1, inner * 8 // n)) / n
        if args.check:
            checks[key] = _equal(
                tuple(ck.multi_step_kernel(s, p, dt, n)[:2]),
                tuple(ck.multi_step_plain(s, p, dt, n)[:2]))
    out["k1_trace"] = _best_ms(lambda: ck.trace(s256, prm256, 49),
                               inner=4) / 48
    if args.check:
        checks["k1_trace"] = _equal(ck.trace(s256, prm256, 49),
                                    ck.trace_plain(s256, prm256, 49))

    cbig = ClothConfig(height=1000, width=1030)
    pbig = ClothParams.from_config(cbig, device=dev)
    sbig = init_cloth_state(cbig, device=dev)
    out["k6_1000x1030"] = _best_ms(lambda: ck.multi_step(sbig, pbig, dt, 48)
                                   ) / 48
    if args.check:
        checks["k6_1000x1030"] = _equal(
            tuple(ck.multi_step(sbig, pbig, dt, 48)[:2]),
            tuple(ctk.multi_step_plain(sbig, pbig, dt, 48)[:2]))
    del sbig

    worlds = datagen.randomized_worlds(
        c60, 1024, torch.Generator().manual_seed(0), device=dev)
    ws, wp = worlds.state, worlds.params
    out["k5_1024"] = _best_ms(lambda: ck.multi_step_kernel(ws, wp, dt, 1),
                              inner=inner)
    if args.check:
        checks["k5_1024"] = _equal(
            tuple(ck.multi_step_kernel(ws, wp, dt, 24)[:2]),
            tuple(ck.multi_step_plain(ws, wp, dt, 24)[:2]))
    del worlds, ws


    fext = torch.randn(s256.pos.shape,
                       generator=torch.Generator().manual_seed(9)).to(dev)
    out["k1f_256"] = _best_ms(lambda: ck.substep_with_force_kernel(
        s256, p256, dt, fext), inner=inner)
    if args.check:
        checks["k1f_256"] = _equal(
            tuple(ck.substep_with_force_kernel(s256, p256, dt, fext)[:2]),
            tuple(ck.substep_with_force_plain(s256, p256, dt, fext)[:2]))

    out["k1_flagship_8_device_us"] = _device_us(
        lambda: ck.multi_step_kernel(s256, p256, dt, 8))


def _window(args, out, checks, inner, dev, c256):
    """The row-window kernels' timings, ms a substep (and checks and
    sweep): K1w on the rows and composed windows, the routed call on the
    rows window, K6w against K1w on the composed window in turns, and the
    rows path end to end."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.ops import cloth_kernel as ck
    from wgpu_physics_engine_torch.ops import cloth_tiled_kernel as ctk

    dt = 1.0 / 480.0

    def window(x, lo, hi, h):
        o = torch.zeros(x.shape[:-2] + (hi - lo, x.shape[-1]),
                        dtype=x.dtype, device=x.device)
        a, b = max(lo, 0), min(hi, h)
        o[..., a - lo:b - lo, :] = x[..., a:b, :]
        return o

    p256 = ClothParams.from_config(c256, device=dev)
    s256 = ck.multi_step_kernel(init_cloth_state(c256, device=dev), p256, dt,
                                2400)
    c1024 = ClothConfig(height=1024, width=1024)
    p1024 = ClothParams.from_config(c1024, device=dev)
    s1024 = init_cloth_state(c1024, device=dev)
    wins = {"k1w_rows": ([window(a, 254, 514, 1024)
                          for a in (s1024.pos, s1024.vel)], 254, 1024),
            "k1w_composed": ([window(a, 124, 260, 256)
                              for a in (s256.pos, s256.vel)], 124, 256)}
    for key, (win, row0, hg) in wins.items():
        pw = p1024 if hg == 1024 else p256
        out[key] = _best_ms(lambda: ck.multi_step_window_kernel(
            *win, None, None, pw, dt, 240, row0, hg)) / 240
        if args.check:
            checks[key] = _equal(
                ck.multi_step_window_kernel(*win, None, None, pw, dt, 8, row0,
                                            hg),
                ck.multi_step_window_plain(*win, None, None, pw, dt, 8, row0,
                                           hg))
    # the routed call on the rows window (K6w above the limit, where the
    # checkout has it), a substep of 240 and a call of 2
    win, row0, hg = wins["k1w_rows"]
    out["k6w_rows"] = _best_ms(lambda: ck.multi_step_window(
        *win, None, None, p1024, dt, 240, row0, hg)) / 240
    out["k6w_rows_2"] = _best_ms(lambda: ck.multi_step_window(
        *win, None, None, p1024, dt, 2, row0, hg), inner=inner)
    if args.check:
        pin = torch.zeros((1024, 1024), dtype=torch.bool, device=dev)
        pin[0] = True
        top = [window(a, -2, 258, 1024) for a in
               (s1024.pos, s1024.vel, pin, s1024.pos)]
        for key, args_w, r0 in (("k6w_rows", win + [None, None], row0),
                                ("k6w_rows_top_pinned", top, -2)):
            for n in (1, 2, 8):
                got = ck.multi_step_window(*args_w, p1024, dt, n, r0, hg)
                checks[f"{key}_{n}"] = {
                    "plain": _equal(got, ck.multi_step_window_plain(
                        *args_w, p1024, dt, n, r0, hg)),
                    "k1w": _equal(got, ck.multi_step_window_kernel(
                        *args_w, p1024, dt, n, r0, hg))}
    # the rows path end to end: the 1024² cloth on 4 row shards of the card,
    # 96 substeps, host clock (the window kernel runs 1 or 2 substeps a
    # call, so the wrapper's host work counts)
    from wgpu_physics_engine_torch.parallel import mesh as pmesh

    rows4 = pmesh.make_mesh((4,), ("rows",), [dev] * 4)
    for k in (1, 2):
        out[f"rows_1024_k{k}_psteps"] = 1024 * 1024 * 96 / _best_s(
            lambda: pmesh.spatial_multi_step(s1024, p1024, dt, 96, rows4,
                                             substeps_per_exchange=k))
    if args.sweep and hasattr(ctk, "multi_step_window_kernel"):
        sweep = {}
        for tile_h in (4, 6, 8, 10, 12, 16, 22, 33):
            for tile_w in (29, 57, 87):
                sched = (1, tile_h, tile_w)
                sweep[f"k6w_rows_{tile_h}x{tile_w}"] = _best_ms(
                    lambda: ctk.multi_step_window_kernel(
                        *win, None, None, p1024, dt, 240, row0, hg,
                        schedule=sched)) / 240
                if args.check:
                    checks[f"k6w_rows_{tile_h}x{tile_w}"] = _equal(
                        ctk.multi_step_window_kernel(
                            *win, None, None, p1024, dt, 2, row0, hg,
                            schedule=sched),
                        ck.multi_step_window_plain(
                            *win, None, None, p1024, dt, 2, row0, hg))
        out["k6w_sweep"] = sweep
    # the composed window on K6w beside K1w, in turns (K1w, K6w, K6w, K1w)
    # within this process, where the checkout has K6w
    if hasattr(ctk, "multi_step_window_kernel"):
        win, row0, hg = wins["k1w_composed"]
        fns = {"k1w_composed": ck.multi_step_window_kernel,
               "k6w_composed": ctk.multi_step_window_kernel}
        turns = {k: [] for k in fns}
        for _ in range(TURNS):
            for k in ("k1w_composed", "k6w_composed", "k6w_composed",
                      "k1w_composed"):
                turns[k].append(_best_ms(lambda: fns[k](
                    *win, None, None, p256, dt, 240, row0, hg)) / 240)
        out["composed_turns"] = turns
        out["k6w_composed"] = min(turns["k6w_composed"])
        if args.check:
            top = [window(a, -4, 132, 256) for a in (s256.pos, s256.vel)]
            for key, (w_, r0) in (("k6w_composed", (win, row0)),
                                  ("k6w_composed_top", (top, -4))):
                for n in (1, 2, 8):
                    got = ctk.multi_step_window_kernel(
                        *w_, None, None, p256, dt, n, r0, hg)
                    checks[f"{key}_{n}"] = {
                        "plain": _equal(got, ck.multi_step_window_plain(
                            *w_, None, None, p256, dt, n, r0, hg)),
                        "k1w": _equal(got, ck.multi_step_window_kernel(
                            *w_, None, None, p256, dt, n, r0, hg))}
    del s1024


def _adjoint(args, out, checks, dev, c256):
    """The cloth adjoint's walk over the training segment's trace at 256²
    (48 substeps of the fresh cloth), ms a substep and device µs (and
    checks)."""
    import torch

    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.ops import cloth_grad_kernel as cg
    from wgpu_physics_engine_torch.ops import cloth_kernel as ck

    dt = 1.0 / 480.0
    n = 48
    s0 = init_cloth_state(c256, device=dev)
    prm = ck._pack_params(ClothParams.from_config(c256, device=dev), dt)
    traj = ck.trace(s0, prm, n)
    g = torch.Generator().manual_seed(5)
    cp, cv = (torch.randn((3, 256, 256), generator=g).to(dev)
              for _ in range(2))
    out["adj_256"] = _best_ms(lambda: cg.walk(traj, cp, cv, prm)) / n
    out["adj_256_device_us"] = _device_us(lambda: cg.walk(traj, cp, cv, prm))
    if args.check:
        pin = torch.zeros((256, 256), dtype=torch.bool, device=dev)
        pin[0] = True
        pins = (pin, s0.pos)
        for key, pn in (("adj_256", None), ("adj_256_pinned", pins)):
            got = cg.walk(traj, cp, cv, prm, pn)
            ref = cg._walk_plain(traj, cp, cv, prm, pn)
            checks[key] = {"state": _equal(got[:2], ref[:2]),
                           "prm": _equal(got[2], ref[2]),
                           "pin": (None if pn is None
                                   else _equal(got[3], ref[3]))}
    del traj


def _raster(args, out, checks, dev, c256, configs):
    """The raster's timings (and checks and sweep)."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.models import scenes
    from wgpu_physics_engine_torch.ops import cloth_kernel
    from wgpu_physics_engine_torch.ops import raster_kernel as rk
    from wgpu_physics_engine_torch.parallel import datagen
    from wgpu_physics_engine_torch.render import camera as cam_mod

    def bins(cam, centers, radius, h, w, batched=False):
        fn = rk.tiled_prologue_batched if batched else rk.tiled_prologue
        b = fn(cam.view[..., :3, :3], cam.eye, centers, radius, cam.znear,
               torch.tan(cam.fovy_rad / 2.0), cam.aspect, h, w)
        return b

    def raster(b, dirs, znear):
        if len(b) == 4:
            return rk.sphere_raster_kernel(b[0], b[1], b[3], dirs, znear)
        return rk.sphere_raster_kernel(b[0], b[1], dirs, znear)

    cases = {}
    flag = scenes.ClothScene(c256, device=dev)
    flag.simulate(5.0)
    cam = flag.camera()
    _, dirs = cam_mod.pixel_rays(cam, 256, 256)
    cases["raster_flagship"] = (
        bins(cam, flag.state.pos.reshape(3, -1).T, c256.particle_radius, 256,
             256), dirs, cam.znear)

    n_dg = 1024
    worlds = datagen.randomized_worlds(
        ClothConfig(), n_dg, torch.Generator().manual_seed(0), device=dev)
    settled = cloth_kernel.multi_step_kernel(worlds.state, worlds.params,
                                             1.0 / 480.0, 1440)
    cams = datagen.randomized_cameras(
        n_dg, torch.Generator().manual_seed(2), device=dev)
    _, ddirs = cam_mod.pixel_rays(cams, 256, 256)
    centers = settled.pos.reshape(n_dg, 3, -1).transpose(1, 2)
    cases["raster_datagen"] = (
        bins(cams, centers, worlds.params.particle_radius, 256, 256, True),
        ddirs, cams.znear)
    del settled, worlds

    gscene = scenes.GranularScene(configs["default"], device=dev)
    gscene.simulate(1.0)
    gcam = gscene.camera()
    _, gdirs = cam_mod.pixel_rays(gcam, 256, 256)
    cases["raster_granular"] = (
        bins(gcam, gscene.state.pos.T, float(configs["default"].radius), 256,
             256), gdirs, gcam.znear)
    del gscene

    for key, (b, d, zn) in cases.items():
        out[key] = _best_ms(lambda: raster(b, d, zn))
        if args.check:
            got = raster(b, d, zn)
            if d.ndim == 4:
                checks[key] = [_equal(tuple(x[i] for x in got),
                                      rk.sphere_raster_plain(b[1][i], d[i],
                                                             zn[i]))
                               for i in (0, n_dg // 2 - 1, n_dg - 1)]
            else:
                checks[key] = _equal(got, rk.sphere_raster_plain(b[1], d, zn))
    if args.sweep and hasattr(rk, "work_list"):
        saved = rk.CHUNK
        sweep = {}
        refs = {key: rk.sphere_raster_plain(b[1], d, zn)
                for key, (b, d, zn) in cases.items()
                if args.check and d.ndim == 3}
        for chunk in (512, 1024, 2048):
            rk.CHUNK = chunk
            for key, (b, d, zn) in cases.items():
                k = f"{key}_C{chunk}"
                sweep[k] = _best_ms(lambda: raster(b, d, zn))
                if key in refs:
                    checks[k] = _equal(raster(b, d, zn), refs[key])
        rk.CHUNK = saved
        out["raster_sweep"] = sweep
    if hasattr(rk, "work_list_kernel"):
        out["raster_datagen_plan"] = _best_ms(
            lambda: rk.work_list_kernel(cases["raster_datagen"][0][0]))
    for key in ("raster_flagship", "raster_datagen"):
        b, d, zn = cases[key]
        out[key + "_device_us"] = _device_us(lambda: raster(b, d, zn))


if __name__ == "__main__":
    sys.exit(main())
