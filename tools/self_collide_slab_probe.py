#!/usr/bin/env python3
"""Dropped window entries of cloth self-collision by slab size, on one
CUDA card.

    python3 tools/self_collide_slab_probe.py

Runs ``models.cloth.multi_step_self_collide`` on the fresh 256² flagship
cloth for 5 simulated seconds at 480 Hz, in 1-second chunks with
``return_stats=True``, and prints for each chunk the worst per-rebuild
dropped count and the host-clock seconds, with the cloth's mean height at
the end: for the scene's grid (skin 2·r, rebuild every 8) at slabs 640 to
2560, and for ``bench.py``'s ``self_collide_256`` schedule (skin 0.5·r,
rebuild every 32, slab 640). ``models.scenes.SELF_COLLIDE_SLAB`` was
chosen from this table.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wgpu_physics_engine_torch.core.config import ClothConfig  # noqa: E402
from wgpu_physics_engine_torch.core.state import (ClothParams,  # noqa: E402
                                                  init_cloth_state)
from wgpu_physics_engine_torch.models import cloth  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("self_collide_slab_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    c = ClothConfig(height=256, width=256)
    p = ClothParams.from_config(c, device=dev)
    for skin_f, rebuild, slabs in ((2.0, 8, (640, 1024, 1280, 1536, 2048,
                                             2560)),
                                   (0.5, 32, (640,))):
        spec = cloth.default_self_collision_grid(
            c, skin=skin_f * c.particle_radius)
        for slab in slabs:
            s = init_cloth_state(c, device=dev)
            drops, ts = [], []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s, d = cloth.multi_step_self_collide(
                    s, p, 1 / 480, 480, spec, rebuild_every=rebuild,
                    pallas_slab=slab, return_stats=True)
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
                drops.append(int(d))
            print(f"skin {skin_f} r rebuild {rebuild} slab {slab} dims "
                  f"{spec.dims}: dropped per second {drops}, s per second "
                  f"{[round(t, 3) for t in ts]}, y mean "
                  f"{float(s.pos[1].mean()):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
