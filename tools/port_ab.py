#!/usr/bin/env python3
"""End-to-end numbers of the PyTorch port's earlier paths on one CUDA card,
for comparing two checkouts of the repo on one machine.

    python3 tools/port_ab.py [--root DIR]

Imports ``wgpu_physics_engine_torch`` from ``DIR`` (default: this
checkout), builds the kernels it needs from that checkout's sources, and
prints one JSON line with the card's name and power limit and:

* ``flagship_psteps``: K1 on the 256² cloth, 3,000 substeps (CUDA events,
  best of 3), particle-steps/s;
* ``k10_ms``, ``k10_thin_ms``: one granular substep at 1M (fresh
  lattice; the default configuration, and the bench configuration's thin
  CIV with slab 640), CUDA events over 10 back-to-back launches, best of
  3;
* ``granular_psteps``: ``granular.multi_step`` at 1M in the bench
  configuration (thin CIV, slab 640, rebuild every 16), 64 substeps, host
  clock with a synchronize, best of 3;
* ``training_psteps``: a loss and its gradient through 480 substeps of the
  256² cloth (``models.cloth.multi_step_diff``, segment 48), host clock,
  best of 3;
* ``k5_ms``: one K5 call, 4,096 worlds of the 60×60 reference cloth × 24
  substeps (CUDA events, best of 3).

Compare two checkouts in turns (A, B, B, A) on one machine in one go:
host clocks on a shared machine spread by up to 2× between machines and
hours.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _best_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def _best_s(fn, reps: int = 3) -> float:
    import torch

    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("port_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.models import cloth, granular
    from wgpu_physics_engine_torch.ops import cloth_kernel
    from wgpu_physics_engine_torch.ops import granular_kernel as gk
    from wgpu_physics_engine_torch.parallel import datagen

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    res = {"root": os.path.abspath(args.root), "card": card}

    c = ClothConfig(height=256, width=256)
    p = ClothParams.from_config(c, device=dev)
    s = init_cloth_state(c, device=dev)
    ms = _best_ms(lambda: cloth_kernel.multi_step(s, p, 1.0 / 480.0, 3000))
    res["flagship_psteps"] = 256 * 256 * 3000 / (ms / 1e3)

    cfg = granular.GranularConfig(num_particles=1_000_000)
    fresh = granular.init_state(cfg, torch.Generator().manual_seed(0),
                                device=dev)
    grid, slabs, _ = granular.rebuild(fresh.pos, fresh.vel, cfg)
    prm = gk.kernel_params(cfg, 1.0 / 240.0, dev)
    res["k10_ms"] = _best_ms(lambda: [gk.substep_sorted(
        grid.sorted_pos, grid.sorted_vel, prm, slabs) for _ in range(10)]) / 10
    bench = granular.GranularConfig(num_particles=1_000_000, rebuild_every=16,
                                    pallas_slab=640, thin=True)
    grid, slabs, _ = granular.rebuild(fresh.pos, fresh.vel, bench)
    res["k10_thin_ms"] = _best_ms(lambda: [gk.substep_sorted(
        grid.sorted_pos, grid.sorted_vel, prm, slabs) for _ in range(10)]) / 10
    sec = _best_s(lambda: granular.multi_step(fresh, bench, 1.0 / 240.0, 64))
    res["granular_psteps"] = 1_000_000 * 64 / sec

    dt = torch.tensor(1.0 / 480.0, device=dev)

    def value_and_grad():
        g = torch.tensor(-9.81, device=dev, requires_grad=True)
        out = cloth.multi_step_diff(s, p._replace(gravity=g), dt, 480,
                                    segment=48)
        torch.autograd.grad(out.pos[1].mean(), g)

    sec = _best_s(value_and_grad)
    res["training_psteps"] = 256 * 256 * 480 / sec

    wb = datagen.randomized_worlds(ClothConfig(), 4096,
                                   torch.Generator().manual_seed(0),
                                   device=dev)
    res["k5_ms"] = _best_ms(lambda: cloth_kernel.multi_step(
        wb.state, wb.params, 1.0 / 480.0, 24))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
