"""CLI entry point: run the flagship cloth scene headless and write a PNG
or an animated GIF.

    python -m wgpu_physics_engine_torch cloth --grid 256 --size 256 256 \\
        --seconds 5 --out cloth.png
    python -m wgpu_physics_engine_torch cloth --seconds 3 --gif cloth.gif

``--device`` defaults to ``cuda``; on a host without CUDA the command
fails (``--device cpu`` runs the plain torch versions of the kernels).
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="wgpu_physics_engine_torch")
    p.add_argument("scene", choices=["cloth"])
    p.add_argument("--out", default=None, help="PNG path for a single frame")
    p.add_argument("--gif", default=None, help="animated GIF path")
    p.add_argument("--seconds", type=float, default=3.0,
                   help="simulated seconds")
    p.add_argument("--fps", type=int, default=20, help="GIF frames/sec")
    p.add_argument("--size", type=int, nargs=2, default=(256, 256),
                   metavar=("H", "W"))
    p.add_argument("--grid", type=int, default=None,
                   help="cloth particles per side (default 60)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    import torch

    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        print(f"error: --device {args.device} requested but CUDA is not "
              "available (pass --device cpu to run the plain torch path)",
              file=sys.stderr)
        return 2

    from .core import config as cfg
    from .models import scenes
    from .utils import viewer

    t0 = time.time()
    c = cfg.ClothConfig() if args.grid is None else cfg.ClothConfig(
        height=args.grid, width=args.grid)
    s = scenes.ClothScene(config=c, device=args.device)
    h, w = args.size
    # App::resize before the first frame: sync the camera aspect to the
    # output size
    s.resize(w, h)
    if args.gif:
        frames = []
        n = int(args.seconds * args.fps)
        for _ in range(n):
            s.update(1.0 / args.fps)
            frames.append(s.render(h, w))
        viewer.save_gif(frames, args.gif, fps=args.fps)
        print(f"wrote {args.gif}: {n} frames in {time.time()-t0:.1f}s")
    else:
        s.simulate(args.seconds)
        out = args.out or f"{args.scene}.png"
        viewer.save_png(s.render(h, w), out)
        print(f"wrote {out} in {time.time()-t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
