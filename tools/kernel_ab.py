#!/usr/bin/env python3
"""Times of the contact pair-force walk (K10, K11, K12, K10b), the cloth
kernels (K1, its trace, K5, K1w, K6w, K1f, K6), the cloth adjoint (K7-K9),
the tile-binned sphere raster (K2/K3) and the untiled one (K4) at their
main-path shapes on one CUDA card, for comparing two checkouts of the repo
on one machine.

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
  48 substeps, ms a substep; ``k1f_256``: K1f at 256², a call of one
  launch;
* part ``resident``: ``k6_1024``: ``cloth_kernel.multi_step``, the routed
  call, on the 1024² cloth draped 3 s (K6, or K6r where the checkout has
  it), 240 substeps, ms a substep; ``k5_1024``, ``k5_64``, ``k5_16``: the
  routed call of 24 substeps (a datagen frame) on 1,024, 64 and 16 worlds
  of the 60×60 cloth settled 3 s (the datagen chunk, the datagen CLI, a
  multi-device shard; K5, or K5r where the checkout routes them there), ms
  a call, and ``k5_<n>_substep``, ms a substep; ``k6w_rows_2``: the rows
  path's routed call of 2 substeps on a shard's 260×1024 window (K6w's
  wrapper, host bound), ms a call, and ``k6w_rows_240``, a call of 240, ms
  a substep (K6w's kernel); ``k6_2048``: K6
  (``cloth_tiled_kernel.multi_step_kernel``) on the fresh 2048² cloth, 48
  substeps, ms a substep;
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
  CTA: ``tools/adjoint_probe.py``); where the checkout has the window
  adjoint, ``win_call_16x16_us`` and ``win_call_136x256_us``: the rows
  path's shard body without a gradient, ``cloth_kernel.
  multi_step_window_packed``, a call of 2 substeps on the example's top
  window and on a composed shard's, µs by host clock over 200 calls, and
  ``win_fn_call_*_us`` the same call through the autograd Function
  (``cloth_grad_kernel.multi_step_window``, no input needing a gradient),
  in turns (direct, Function, Function, direct);
* ``raster_flagship``: the 256×256 frame of the 256² flagship after
  ``simulate(5.0)``, 65,536 instances; ``raster_datagen``: one call on a
  chunk of 1,024 worlds of the 60×60 cloth settled 3 s, randomized
  cameras, 256×256; ``raster_granular``: the 256×256 frame of the 1M
  ``GranularScene`` after ``simulate(1.0)``;
* part ``k1f_k4``: on the 256² cloth of ``ClothScene(self_collide=True)``
  after ``simulate(2.0)``, one rebuild block of 8 substeps
  (``models.cloth._self_collide_block`` with the scene's grid and slab, the
  main path's): ``k1f_sc_device_us``, K1f's device µs a launch from a
  ``torch.profiler`` trace of five blocks (CUDA events around a launch
  read its wrapper's host issue); ``sc_block_ms``, the block by CUDA
  events (best of 5), ``sc_block_host_ms`` by host clock, and
  ``sc_block_device_us`` and ``sc_block_ops``, its device busy time and
  device ops from a trace; ``k4_10_device_us`` and ``k4_16384_device_us``:
  K4 (``raster_kernel.sphere_raster_untiled_kernel``) on the 600×800 frame
  of ``FreeParticleScene`` after ``simulate(3.0)`` with its 10 instances
  and with 16,384 of radius 0.25 in the box, device µs a launch from a
  trace of five, and ``k4_10_ms``, ``k4_16384_ms`` by CUDA events;
* part ``rows_grad``, the differentiable rows path at its main-path
  sites: ``rows_grad_example_iter_ms``, an iteration of
  ``examples/multichip_training.py`` (its loss, backward and Adam step on
  8 shards of the card), ms by host clock over 10 iterations, best of 5;
  ``rows_grad_composed_host_ms`` and ``rows_grad_composed_events_ms``, a
  value_and_grad of the composed cell (8 worlds of 256² with seeded
  velocities on a (2, 2) worlds × rows mesh, 48 substeps at k = 2, a
  trajectory-matching loss at 0.8 k_struct, gradients in log k_struct and
  pos0; ``chip_smoke.py`` phase 25's cell) by host clock and CUDA
  events, best of 5, and ``rows_grad_rows_host_ms``,
  ``rows_grad_rows_events_ms`` the same for the rows cell (the 1024²
  cloth, top row pinned, on 4 rows shards); for each of ``example``,
  ``composed`` and ``rows``, ``rows_grad_<site>_device`` from a
  ``torch.profiler`` trace of one such call: per kernel (``k1w_trace``:
  K1w and the window trace, which launch one ``__global__`` function;
  ``adjoint``: the window adjoint; ``reduce``: its reductions; ``k6w``)
  the launches, the device µs and the µs a launch, with the device's busy
  µs and op count;
* part ``render_epilogue`` (a checkout with ``ops/pixel_kernel.py``), the
  datagen render's per-pixel chains at the codec cell's chunk (1,024
  worlds of the 60×60 cloth settled 3 s, randomized cameras, cached
  globes, 256×256): the rays kernel against ``pixel_dirs_plain`` and the
  epilogue kernel against the torch chain it replaces (the flat route's
  shade and composite of ``draw_instanced_spheres``, ``render.raster.
  _flat_composite``, and the cast, ``to_rgb8``), each
  pair timed in turns (plain, kernel, kernel, plain, ...), ``PAIRS``
  pairs by CUDA events, ms a call: ``rays_kernel_ms``, ``rays_plain_ms``,
  ``epilogue_kernel_ms``, ``epilogue_plain_ms`` (medians), each side's
  times in ``render_epilogue_pairs``, the kernels' bounds
  (``rays_bound_ms``, ``epilogue_bound_ms``: 12 and 27 bytes a pixel at
  3.35 TB/s), the device µs of each kernel from a trace, and whether each
  kernel equals its plain chain bit for bit (``render_epilogue_bitwise``);
* with ``--sweep`` (a checkout with K6w) K6w on the rows window over tile
  heights and widths at k = 1; (a checkout whose walk has
  ``walk_geometry``), K11 and
  K10-thin over lanes and CTA sizes; (a checkout whose walk has
  ``staged``) K10, K11 and K12 at 1M, K10-thin and K11 on the
  self-collision set over the staged and the direct walk; and (a checkout
  whose raster has a work list) the raster over chunk sizes;
* with ``--check``, each kernel against its plain version: the largest
  difference and whether they are equal bit for bit;
* with ``--only`` and one or more of ``walk``, ``cloth``, ``resident``,
  ``window``, ``adjoint``, ``raster``, ``k1f_k4``, ``rows_grad`` and
  ``render_epilogue``, only those parts (``k1f_k4``, ``rows_grad`` and
  ``render_epilogue`` run only when named); with ``e2e`` among them, also the host-bound loops the
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
# pairs of (plain chain, kernel) in part render_epilogue, the first of a
# pair alternating
PAIRS = 10


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
                    choices=("walk", "cloth", "resident", "window", "adjoint",
                             "raster", "k1f_k4", "rows_grad",
                             "render_epilogue", "e2e"))
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
                 "cloth_tiled", "cloth_grad", "sphere_raster_untiled"):
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
    parts = (("walk", "cloth", "resident", "window", "adjoint", "raster")
             if args.only is None else args.only)
    if "walk" in parts:
        _walk(args, out, checks, inner, dev, c256, configs, sc_set)
    if "cloth" in parts:
        _cloth(args, out, checks, inner, dev, c256)
    if "resident" in parts:
        _resident(args, out, checks, inner, dev)
    if "window" in parts:
        _window(args, out, checks, inner, dev, c256)
    if "adjoint" in parts:
        _adjoint(args, out, checks, dev, c256)
    if "raster" in parts:
        _raster(args, out, checks, dev, c256, configs)
    if "k1f_k4" in parts:
        _k1f_k4(args, out, checks, dev, c256)
    if "rows_grad" in parts:
        _rows_grad(out, dev)
    if "render_epilogue" in parts:
        _render_epilogue(out, dev)
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


def _resident(args, out, checks, inner, dev):
    """The routed calls that have resident kernels: the 1024² cloth
    (K6, or K6r where the checkout has it) and batches of the 60×60 cloth
    (K5, or K5r), and the rows window's call of 2 (K6w's wrapper), ms a
    substep and a call (and checks)."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.ops import cloth_kernel as ck
    from wgpu_physics_engine_torch.ops import cloth_tiled_kernel as ctk
    from wgpu_physics_engine_torch.parallel import datagen

    dt = 1.0 / 480.0
    c1024 = ClothConfig(height=1024, width=1024)
    p1024 = ClothParams.from_config(c1024, device=dev)
    s1024 = ck.multi_step_kernel(init_cloth_state(c1024, device=dev), p1024,
                                 dt, 1440)
    out["k6_1024"] = _best_ms(lambda: ck.multi_step(s1024, p1024, dt, 240)
                              ) / 240
    if args.check:
        checks["k6_1024"] = _equal(
            tuple(ck.multi_step(s1024, p1024, dt, 13)[:2]),
            tuple(ctk.multi_step_plain(s1024, p1024, dt, 13)[:2]))
    # the rows path's routed call of 2 on a shard's 260×1024 window
    win = []
    for a in (s1024.pos, s1024.vel):
        o = torch.zeros((3, 260, 1024), device=dev)
        o[:] = a[:, 254:514]
        win.append(o)
    out["k6w_rows_2"] = _best_ms(lambda: ck.multi_step_window(
        *win, None, None, p1024, dt, 2, 254, 1024), inner=inner)
    out["k6w_rows_240"] = _best_ms(lambda: ck.multi_step_window(
        *win, None, None, p1024, dt, 240, 254, 1024)) / 240
    if args.check:
        checks["k6w_rows_240"] = _equal(
            ck.multi_step_window(*win, None, None, p1024, dt, 13, 254, 1024),
            ck.multi_step_window_plain(*win, None, None, p1024, dt, 13, 254,
                                       1024))
    del s1024, win
    c2048 = ClothConfig(height=2048, width=2048)
    p2048 = ClothParams.from_config(c2048, device=dev)
    s2048 = init_cloth_state(c2048, device=dev)
    out["k6_2048"] = _best_ms(lambda: ctk.multi_step_kernel(
        s2048, p2048, dt, 48)) / 48
    if args.check:
        checks["k6_2048"] = _equal(
            tuple(ctk.multi_step_kernel(s2048, p2048, dt, 8)[:2]),
            tuple(ctk.multi_step_plain(s2048, p2048, dt, 8)[:2]))
    del s2048

    worlds = datagen.randomized_worlds(
        ClothConfig(), 1024, torch.Generator().manual_seed(0), device=dev)
    worlds = datagen.WorldBatch(
        state=ck.multi_step_kernel(worlds.state, worlds.params, dt, 1440),
        params=worlds.params)
    for n in (1024, 64, 16):
        ws = worlds.state._replace(pos=worlds.state.pos[:n].contiguous(),
                                   vel=worlds.state.vel[:n].contiguous())
        wp = ClothParams(*(a[:n] for a in worlds.params))
        out[f"k5_{n}"] = _best_ms(lambda: ck.multi_step(ws, wp, dt, 24),
                                  inner=max(1, inner * 16 // n))
        out[f"k5_{n}_substep"] = out[f"k5_{n}"] / 24
        if args.check:
            checks[f"k5_{n}"] = _equal(
                tuple(ck.multi_step(ws, wp, dt, 24)[:2]),
                tuple(ck.multi_step_plain(ws, wp, dt, 24)[:2]))
    del worlds


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

    from wgpu_physics_engine_torch.core.config import ClothConfig
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
    if hasattr(cg, "multi_step_window"):
        calls = 200
        for name, hg, rows in (("16x16", 16, 16), ("136x256", 256, 136)):
            c = ClothConfig(height=hg, width=hg)
            s = init_cloth_state(c, device=dev)
            pw = ck._pack_params(ClothParams.from_config(c, device=dev), dt)
            win = [torch.zeros((3, rows, hg), device=dev) for _ in range(2)]
            win[0][:, 4:] = s.pos[:, :rows - 4]
            fns = {"direct": lambda: ck.multi_step_window_packed(
                       *win, None, None, pw, 2, -4, hg),
                   "function": lambda: cg.multi_step_window(
                       *win, None, None, pw, 2, -4, hg)}
            us = {k: [] for k in fns}
            for k in ("direct", "function", "function", "direct"):
                us[k].append(_best_s(lambda: [fns[k]() for _ in range(calls)])
                             / calls * 1e6)
            out[f"win_call_{name}_us"] = min(us["direct"])
            out[f"win_fn_call_{name}_us"] = min(us["function"])
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


def _render_epilogue(out, dev):
    """The datagen render's per-pixel chains, kernel against plain chain in
    turns, at the codec cell's chunk."""
    import statistics

    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.ops import cloth_kernel
    from wgpu_physics_engine_torch.ops import pixel_kernel as pk
    from wgpu_physics_engine_torch.parallel import datagen
    from wgpu_physics_engine_torch.render import camera as cam_mod
    from wgpu_physics_engine_torch.render import raster

    n, h, w = 1024, 256, 256
    worlds = datagen.randomized_worlds(
        ClothConfig(), n, torch.Generator().manual_seed(0), device=dev)
    pos = cloth_kernel.multi_step(worlds.state, worlds.params, 1.0 / 480.0,
                                  1440).pos
    cams = datagen.randomized_cameras(
        n, torch.Generator().manual_seed(2), device=dev)
    base = datagen.globe_base_fbs(cams, worlds.params,
                                  datagen.globe_texture(dev))
    centers = pos.reshape(n, 3, -1).transpose(1, 2)
    tan_half = torch.tan(cams.fovy_rad / 2.0)
    eye, dirs = cam_mod.pixel_rays_plain(cams, h, w)
    tmin, inst, _, _ = raster._nearest_hits(
        cams, eye, dirs, centers, worlds.params.particle_radius)
    del pos, worlds

    def rays_plain():
        return cam_mod.pixel_dirs_plain(cams.view, tan_half, cams.aspect, h,
                                        w)

    def rays_kernel():
        return pk.pixel_rays(cams.view, tan_half, cams.aspect, h, w)

    def epilogue_plain():
        fb = raster._flat_composite(base, cams, eye, dirs, tmin, inst >= 0,
                                    (1.0, 0.0, 0.0))
        return raster.to_rgb8(fb.color)

    def epilogue_kernel():
        return pk.flat_composite_rgb8(tmin, inst, base.color, base.depth,
                                      cams.view, eye, cams.proj, tan_half,
                                      cams.aspect, (1.0, 0.0, 0.0))

    def once(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    pairs = {}
    for name, plain, kernel in (("rays", rays_plain, rays_kernel),
                                ("epilogue", epilogue_plain,
                                 epilogue_kernel)):
        plain(), kernel()
        torch.cuda.synchronize()
        times = {"plain": [], "kernel": []}
        for i in range(PAIRS):
            order = (("plain", plain), ("kernel", kernel))
            for side, fn in (order if i % 2 == 0 else order[::-1]):
                times[side].append(once(fn))
        pairs[name] = times
        for side in ("plain", "kernel"):
            out[f"{name}_{side}_ms"] = statistics.median(times[side])
    out["render_epilogue_pairs"] = pairs
    px = n * h * w
    out["rays_bound_ms"] = px * 12 / 3.35e12 * 1e3
    out["epilogue_bound_ms"] = px * 27 / 3.35e12 * 1e3
    out["rays_kernel_device_us"] = _trace_device(
        rays_kernel, lambda name: "wpe_pixel_rays" in name)[0]
    out["epilogue_kernel_device_us"] = _trace_device(
        epilogue_kernel, lambda name: "wpe_flat_composite_rgb8" in name)[0]
    out["render_epilogue_bitwise"] = {
        "rays": torch.equal(rays_kernel(), rays_plain()),
        "epilogue": torch.equal(epilogue_kernel(), epilogue_plain())}


def _trace_device(fn, match) -> tuple:
    """One torch.profiler trace of ``fn``: the device µs and count of the
    kernels whose name ``match`` accepts, the device busy µs of all ops
    and their count."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    hit = [e.device_time for e in ev if match(e.name)]
    return sum(hit), len(hit), sum(e.device_time for e in ev), len(ev)


def _rows_grad(out, dev):
    """The differentiable rows path's sites: the training example's
    iteration, the composed and rows cells' value_and_grad, and their
    window kernels' device time from a trace (the module's
    ``rows_grad``)."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams, ClothState,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.examples import multichip_training as mt
    from wgpu_physics_engine_torch.parallel import datagen
    from wgpu_physics_engine_torch.parallel import mesh as pmesh

    dt, steps, k = 1.0 / 480.0, 48, 2
    kernels = {"k1w_trace": "substep_kernel_window", "adjoint": "vjp_substep",
               "reduce": "reduce_partials", "k6w": "tiled_kernel"}

    def device(fn):
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        res = {"busy_us": sum(e.device_time for e in ev), "ops": len(ev)}
        for key, name in kernels.items():
            ts = [e.device_time for e in ev if name in e.name]
            res[key] = {"launches": len(ts), "us": sum(ts),
                        "us_a_launch": sum(ts) / len(ts) if ts else None}
        return res

    # the training example: an iteration of its loop
    m, _, params, state = mt.make_problem(device=dev)
    with torch.no_grad():
        target = mt.rollout(state, params, m)
    log_k = torch.log(0.5 * params.k_struct).detach().requires_grad_(True)
    opt, sched = mt.make_optimizer(log_k)

    def iteration():
        opt.zero_grad()
        mt.loss_fn(log_k, state, params, m, target).backward()
        opt.step()
        sched.step()

    out["rows_grad_example_iter_ms"] = _best_s(
        lambda: [iteration() for _ in range(10)]) / 10 * 1e3
    out["rows_grad_example_device"] = device(iteration)

    # the two cells of chip_smoke.py phase 25
    c_fl = ClothConfig(height=256, width=256)
    fl = datagen.randomized_worlds(c_fl, 8, torch.Generator().manual_seed(21),
                                   device=dev)
    c_lg = ClothConfig(height=1024, width=1024)
    s_lg = init_cloth_state(c_lg, device=dev)
    pin = torch.zeros((1024, 1024), dtype=torch.bool, device=dev)
    pin[0] = True
    g = torch.Generator().manual_seed(25)
    vel = [(0.5 * torch.randn(x.shape, generator=g)).to(dev)
           for x in (fl.state.vel, s_lg.vel)]
    cells = {
        "composed": (ClothState(pos=fl.state.pos, vel=vel[0]),
                     ClothParams.from_config(c_fl, device=dev),
                     pmesh.make_mesh((2, 2), ("worlds", "rows"), [dev] * 4)),
        "rows": (s_lg._replace(vel=vel[1], pin_mask=pin, pin_pos=s_lg.pos),
                 ClothParams.from_config(c_lg, device=dev),
                 pmesh.make_mesh((4,), ("rows",), [dev] * 4))}

    def rollout(st, p, mesh, lk):
        p = p._replace(k_struct=torch.exp(lk))
        if st.pos.ndim == 3:
            return pmesh.spatial_multi_step(st, p, dt, steps, mesh,
                                            substeps_per_exchange=k).pos
        return pmesh.batched_spatial_multi_step(st, p, dt, steps, mesh,
                                                substeps_per_exchange=k).pos

    for name, (st, p, mesh) in cells.items():
        with torch.no_grad():
            tgt = rollout(st, p, mesh, torch.log(p.k_struct))

        def value_and_grad():
            lk = torch.log(0.8 * p.k_struct).detach().requires_grad_(True)
            pos0 = st.pos.detach().clone().requires_grad_(True)
            o = rollout(st._replace(pos=pos0), p, mesh, lk)
            torch.autograd.grad(torch.mean((o - tgt) ** 2), (lk, pos0))

        out[f"rows_grad_{name}_host_ms"] = _best_s(value_and_grad) * 1e3
        out[f"rows_grad_{name}_events_ms"] = _best_ms(value_and_grad)
        out[f"rows_grad_{name}_device"] = device(value_and_grad)


def _k1f_k4(args, out, checks, dev, c256):
    """K1f in the self-collision block and K4 on the free-particle frame
    (and checks)."""
    import torch

    from wgpu_physics_engine_torch.core.config import FreeParticleConfig
    from wgpu_physics_engine_torch.models import broadphase, cloth, scenes
    from wgpu_physics_engine_torch.ops import cloth_kernel as ck
    from wgpu_physics_engine_torch.ops import granular_kernel as gk
    from wgpu_physics_engine_torch.ops import raster_kernel as rk
    from wgpu_physics_engine_torch.render import camera as cam_mod

    dt = 1.0 / 480.0
    scene = scenes.ClothScene(c256, self_collide=True, device=dev)
    scene.simulate(2.0)
    st, prm = scene.state, scene.params

    def block():
        return cloth._self_collide_block(st, prm, dt, 8, scene._sc_grid, 256,
                                         scenes.SELF_COLLIDE_SLAB)

    def k1f(name):
        # the parent's K1f is substep_kernel<..., EXT = true>, the only
        # substep_kernel a block launches
        return "force_kernel" in name or "substep_kernel" in name

    us, n, _, _ = _trace_device(lambda: [block() for _ in range(5)], k1f)
    out["k1f_sc_device_us"] = us / max(n, 1)
    out["k1f_sc_launches_traced"] = n
    out["sc_block_ms"] = _best_ms(block)
    out["sc_block_host_ms"] = _best_s(block) * 1e3
    _, _, busy, ops = _trace_device(block, k1f)
    out["sc_block_device_us"], out["sc_block_ops"] = busy, ops
    if args.check:
        n = st.pos.shape[-1] * st.pos.shape[-2]
        grid, slabs, _ = cloth._frozen_structs(
            st.pos.reshape(3, n), st.vel.reshape(3, n), scene._sc_grid, 256,
            scenes.SELF_COLLIDE_SLAB)
        inv = broadphase._inverse(grid.order)
        f = gk.contact_forces_sorted_kernel(
            grid.sorted_pos, 2.0 * prm.particle_radius, prm.k_contact, slabs)
        fg = f[:, inv].reshape(st.pos.shape)
        checks["k1f_sc"] = _equal(
            tuple(ck.substep_with_force_kernel(st, prm, dt, fg)[:2]),
            tuple(ck.substep_with_force_plain(st, prm, dt, fg)[:2]))
        if hasattr(ck, "force_block"):
            blk, sb = ck.force_block(st, prm, dt, inv)
            got, sp = ck.substep_with_force_sorted_kernel(sb, blk, f)
            ref, rsp = ck.substep_with_force_sorted_plain(sb, blk, f)
            checks["k1f_sc_sorted"] = _equal((got.pos, got.vel, sp),
                                             (ref.pos, ref.vel, rsp))

    ps = scenes.FreeParticleScene(FreeParticleConfig(), seed=0, device=dev)
    ps.simulate(3.0)
    ps.resize(800, 600)
    cam = ps.camera()
    eye, dirs = cam_mod.pixel_rays(cam, 600, 800)
    g = torch.Generator().manual_seed(0)
    big = ((torch.rand((rk.MAX_INSTANCES, 3), generator=g) * 2.0 - 1.0)
           * 9.75).to(dev)
    for key, centers, radius in (
            ("k4_10", ps.state.pos.T.contiguous(), float(ps.params.radius)),
            ("k4_16384", big, 0.25)):
        ocb = rk.untiled_prologue(eye, centers, radius)

        def k4():
            return rk.sphere_raster_untiled_kernel(ocb, dirs, cam.znear)

        us, n, _, _ = _trace_device(lambda: [k4() for _ in range(5)],
                                    lambda name: "sphere_raster_untiled" in
                                    name)
        out[key + "_device_us"] = us / max(n, 1)
        out[key + "_ms"] = _best_ms(k4)
        if args.check:
            checks[key] = _equal(k4(), rk.sphere_raster_untiled_plain(
                ocb, dirs, cam.znear))


if __name__ == "__main__":
    sys.exit(main())
