#!/usr/bin/env python3
"""Dropped window entries of the granular pile's default configuration,
rebuild by rebuild, and the JAX package's count on the same positions.

    python3 tools/granular_drop_probe.py port [--out FILE]
    python3 tools/granular_drop_probe.py jax FILE

``port`` (the PyTorch port, one CUDA card): steps the 1M default pile
(``GranularConfig()``, seed 0, dt 1/240) 64 substeps through
``granular.multi_step``'s kernel route, block by block with its
sort-carry, and prints for each rebuild the exact dropped count
(``build_offsets_civ(stats=True)``) and the fast indicator. It saves the
positions that enter the rebuild with the most drops to ``--out``
(default ``chiprun_out/granular_drop_state.npz``): the rebuild reads only
positions.

``jax`` (the CPU, the JAX package): loads that file and runs the JAX
package's own rebuild on it (``broadphase.build_sorted_grid`` and
``granular_pallas.build_offsets_civ`` with the JAX ``GranularConfig``
defaults and its single-device ``n_pad``), printing the exact and the
fast count. One rebuild at 1M: ~1 GB and a few seconds. Equal counts
mean the drops are the configuration's (its ``pallas_slab`` of 384
against the window hull of a 128-slot block), not the port's.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N = 1_000_000
DT = 1.0 / 240.0
STEPS = 64


def port(out: str) -> int:
    import numpy as np
    import torch

    from wgpu_physics_engine_torch.models import granular
    from wgpu_physics_engine_torch.ops import granular_kernel

    if not torch.cuda.is_available():
        print("granular_drop_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = granular.GranularConfig(num_particles=N)
    s = granular.init_state(cfg, torch.Generator().manual_seed(0), device=dev)
    pos, vel = s.pos, s.vel
    k = cfg.rebuild_every
    worst, worst_pos, drops = -1, None, []
    for b in range(-(-STEPS // k)):
        length = min(k, STEPS - b * k)
        _, _, fast = granular.rebuild(pos, vel, cfg, stats=False)
        _, _, exact = granular.rebuild(pos, vel, cfg, stats=True)
        exact, fast = int(exact), int(fast)
        drops.append((b * k, exact, fast))
        if exact > worst:
            worst, worst_pos = exact, pos.cpu().numpy()
        pos, vel, _, _ = granular._run_block_kernel(pos, vel, cfg, DT, length)
    print(f"{torch.cuda.get_device_name(0)}; default configuration, {N} "
          f"particles, slab {cfg.pallas_slab}, block {cfg.pallas_block}, "
          f"rebuild every {k}")
    for at, exact, fast in drops:
        print(f"rebuild at substep {at}: dropped exact {exact}, fast {fast}")
    print(f"K10 launches {granular_kernel.LAUNCHES}; worst exact {worst}")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, pos=worst_pos, dropped=np.int64(worst))
    print(f"saved the positions of that rebuild to {out}")
    return 0


def jax_count(path: str) -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from wgpu_physics_engine_tpu.models import broadphase, granular
    from wgpu_physics_engine_tpu.ops import granular_pallas

    f = np.load(path)
    pos = jnp.asarray(f["pos"])
    cfg = granular.GranularConfig(num_particles=pos.shape[-1])
    spec = cfg.grid_spec()
    grid = broadphase.build_sorted_grid(pos, jnp.zeros_like(pos), spec)
    block, slab = cfg.pallas_block, cfg.pallas_slab
    n_pad = -(-max(pos.shape[-1], slab) // block) * block
    counts = {}
    for stats in (True, False):
        _, _, d = granular_pallas.build_offsets_civ(
            grid, spec, block, slab, n_pad, thin=cfg.thin, stats=stats)
        counts["exact" if stats else "fast"] = int(d)
    print(f"JAX build_offsets_civ on {path}: dropped exact "
          f"{counts['exact']}, fast {counts['fast']}; the port's exact count "
          f"{int(f['dropped'])}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("port")
    c.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "granular_drop_state.npz"))
    j = sub.add_parser("jax")
    j.add_argument("path")
    a = ap.parse_args(argv)
    if a.mode == "port":
        return port(a.out)
    return jax_count(a.path)


if __name__ == "__main__":
    sys.exit(main())
