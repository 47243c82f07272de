"""CLI entry point: run a scene headless (the mesh cube, textured cube
and globe, the free-particle box, the flagship cloth or the granular
pile) and write a PNG or an animated GIF or stream it to the terminal,
generate a batched cloth or granular dataset, or decode one.

    python -m wgpu_physics_engine_torch cube --size 600 800 --out cube.png
    python -m wgpu_physics_engine_torch textured --out tex.png
    python -m wgpu_physics_engine_torch globe --out globe.png
    python -m wgpu_physics_engine_torch particles --size 600 800 \\
        --seconds 4 --gif box.gif
    python -m wgpu_physics_engine_torch cloth --grid 256 --size 256 256 \\
        --seconds 5 --out cloth.png
    python -m wgpu_physics_engine_torch cloth --seconds 3 --gif cloth.gif
    python -m wgpu_physics_engine_torch cloth --live --seconds 3
    python -m wgpu_physics_engine_torch cloth --self-collide --grid 256 \\
        --out cloth_sc.png
    python -m wgpu_physics_engine_torch granular --particles 1000000 \\
        --seconds 2 --size 256 256 --out pile.png
    python -m wgpu_physics_engine_torch datagen --worlds 64 --frames 8 \\
        --codec-k 16 --outdir datagen_out
    python -m wgpu_physics_engine_torch datagen --family granular \\
        --worlds 64 --frames 2 --codec-k 16 --random-cameras
    python -m wgpu_physics_engine_torch decode --indir datagen_out

``--device`` defaults to ``cuda``; on a host without CUDA the command
fails (``--device cpu`` runs the plain torch versions of the kernels).
``datagen`` writes one ``frame_NNNNN.npy`` shard per frame, through the
native async writer (``native.ShardWriter``, built with g++ at first use)
where it builds, else ``np.save``, and says which; with ``--codec-k`` also
the codec's ``codec_meta.json`` sidecar, which ``decode`` reads.
``--family granular`` runs 20,000-particle piles (``--particles``) with
per-world materials, 12 substeps a frame at 240 Hz.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="wgpu_physics_engine_torch")
    p.add_argument("scene", choices=["cube", "textured", "globe", "particles",
                                     "cloth", "granular", "datagen",
                                     "decode"])
    p.add_argument("--out", default=None, help="PNG path for a single frame")
    p.add_argument("--gif", default=None, help="animated GIF path")
    p.add_argument("--live", action="store_true",
                   help="stream frames to the terminal (ANSI truecolor)")
    p.add_argument("--seconds", type=float, default=3.0,
                   help="simulated seconds (cloth, particles, granular; "
                        "a GIF's length for every scene)")
    p.add_argument("--fps", type=int, default=20, help="GIF frames/sec")
    p.add_argument("--size", type=int, nargs=2, default=(256, 256),
                   metavar=("H", "W"))
    p.add_argument("--grid", type=int, default=None,
                   help="cloth particles per side (default 60)")
    p.add_argument("--particles", type=int, default=None,
                   help="granular: particle count (default 20000)")
    p.add_argument("--self-collide", action="store_true",
                   help="cloth: enable cloth-cloth contact (spatial hash)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--worlds", type=int, default=64,
                   help="datagen: number of worlds")
    p.add_argument("--frames", type=int, default=8,
                   help="datagen: frames per world")
    p.add_argument("--family", choices=["cloth", "granular"],
                   default="cloth",
                   help="datagen: model family (granular = per-world "
                        "material constants on the kernel's parameters)")
    p.add_argument("--outdir", default="datagen_out")
    p.add_argument("--random-cameras", action="store_true",
                   help="datagen: randomize the viewpoint per world")
    p.add_argument("--codec-k", type=int, default=None, metavar="K",
                   help="datagen: compress frames on the device with the "
                        "fixed-rate DCT codec, keeping K of 64 coefficients "
                        "(64/K x fewer bytes; decode with the decode command)")
    p.add_argument("--seed", type=int, default=0,
                   help="datagen: seed of the worlds' and cameras' draws")
    p.add_argument("--indir", default="datagen_out",
                   help="decode: directory of encoded frame_*.npy shards")
    p.add_argument("--png", action="store_true",
                   help="decode: also write per-world PNGs (else .npy only)")
    p.add_argument("--quality", type=float, default=None,
                   help="codec quality (encode: quantization scale, default "
                        "1.0; decode: normally read from the run's "
                        "codec_meta.json sidecar)")
    p.add_argument("--force-quality", action="store_true",
                   help="decode: trust --quality even when the sidecar is "
                        "missing or disagrees")
    args = p.parse_args(argv)

    if args.scene == "decode":
        return _decode(args)

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
    if args.scene == "datagen":
        return _datagen(args, c, t0)
    if args.scene == "cube":
        s = scenes.CubeScene(device=args.device)
    elif args.scene == "textured":
        s = scenes.TexturedCubeScene(device=args.device)
    elif args.scene == "globe":
        s = scenes.GlobeScene(device=args.device)
    elif args.scene == "particles":
        s = scenes.FreeParticleScene(
            config=cfg.FreeParticleConfig(num_particles=10),
            device=args.device)
    elif args.scene == "granular":
        from .models.granular import GranularConfig

        s = scenes.GranularScene(
            config=GranularConfig(num_particles=args.particles or 20_000),
            device=args.device)
    else:
        s = scenes.ClothScene(config=c, self_collide=args.self_collide,
                              device=args.device)
    h, w = args.size
    # App::resize before the first frame: sync the camera aspect to the
    # output size
    s.resize(w, h)
    if args.live:
        viewer.live(s, seconds=args.seconds, fps=args.fps, size=(h, w))
        return 0
    if args.gif:
        frames = []
        n = int(args.seconds * args.fps)
        for _ in range(n):
            s.update(1.0 / args.fps)
            frames.append(s.render(h, w))
        viewer.save_gif(frames, args.gif, fps=args.fps)
        print(f"wrote {args.gif}: {n} frames in {time.time()-t0:.1f}s")
    else:
        if hasattr(s, "simulate"):
            s.simulate(args.seconds)
        out = args.out or f"{args.scene}.png"
        viewer.save_png(s.render(h, w), out)
        print(f"wrote {out} in {time.time()-t0:.1f}s")
    return 0


def _datagen(args, c, t0) -> int:
    """Batched datagen, cloth or granular: one ``frame_NNNNN.npy`` shard
    per frame, through the native async writer where it builds."""
    import os

    import numpy as np
    import torch

    from . import native
    from .parallel import codec

    quality = args.quality if args.quality is not None else 1.0
    gen_kw = dict(n_worlds=args.worlds, n_frames=args.frames,
                  generator=torch.Generator().manual_seed(args.seed),
                  fb_size=tuple(args.size),
                  randomize_cameras=args.random_cameras, codec_k=args.codec_k,
                  codec_quality=quality, device=args.device)
    if args.family == "granular":
        from .models.granular import GranularConfig
        from .parallel import datagen_granular

        gen = datagen_granular.generate_granular_dataset(
            GranularConfig(num_particles=args.particles or 20_000),
            steps_per_frame=12, hz=240.0, **gen_kw)
    else:
        from .parallel import datagen

        gen = datagen.generate_trajectory_dataset(c, steps_per_frame=24,
                                                  **gen_kw)
    os.makedirs(args.outdir, exist_ok=True)
    if args.codec_k is not None:
        codec.write_meta(args.outdir, args.codec_k, quality, args.size)
    # the async C++ writer copies each frame and writes it on its own
    # thread, so the disk IO overlaps the next frame's compute
    writer = native.ShardWriter() if native.available() else None
    print(f"datagen {args.family}: shard writer "
          + ("native (async, C++)" if writer is not None else "np.save"))
    n = 0
    for f, imgs, _ in gen:
        path = os.path.join(args.outdir, f"frame_{f:05d}.npy")
        if writer is not None:
            writer.submit(path, imgs)
        else:
            np.save(path, imgs)
        n += imgs.shape[0]
        print(f"frame {f}: {imgs.shape} -> {path}")
    if writer is not None:
        written = writer.close()
        print(f"native writer: {written} shards")
        if written < 0:
            print(f"native writer: {-written} shards failed", file=sys.stderr)
            return 1
    print(f"datagen: {n} world-frames in {time.time()-t0:.1f}s")
    return 0


def _decode(args) -> int:
    """Decode a datagen run's codec shards to uint8 frames (NumPy only)."""
    import glob
    import os

    import numpy as np

    from .parallel import codec

    t0 = time.time()
    os.makedirs(args.outdir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.indir, "frame_*.npy")))
    if not paths:
        print(f"no frame_*.npy shards in {args.indir}")
        return 1

    # header-only peek (mmap loads no data): raw-uint8 runs (datagen
    # without --codec-k) have nothing to decode and need no sidecar
    def is_codec(path):
        a = np.load(path, mmap_mode="r")
        return a.dtype == np.int8 and a.ndim == 5

    if not any(is_codec(path) for path in paths):
        for path in paths:
            print(f"skip {path}: not a codec shard")
        print("decode: 0 world-frames (no codec shards)")
        return 0
    # quality comes from the run's sidecar — a wrong value silently
    # rescales every decoded pixel, so refuse to guess
    try:
        meta = codec.read_meta(args.indir)
    except FileNotFoundError:
        meta = None
    except ValueError as e:
        print(f"{args.indir}: {e}")
        return 1
    if meta is None:
        if not args.force_quality:
            print(f"{args.indir}: no codec_meta.json sidecar; pass "
                  "--quality Q --force-quality to decode anyway")
            return 1
        quality = args.quality if args.quality is not None else 1.0
    else:
        quality = meta["quality"]
        if (args.quality is not None and args.quality != quality
                and not args.force_quality):
            print(f"--quality {args.quality} disagrees with the sidecar "
                  f"({quality}); drop the flag or pass --force-quality")
            return 1
        if args.force_quality and args.quality is not None:
            quality = args.quality
    n = 0
    for path in paths:
        enc = np.load(path)
        if enc.dtype != np.int8 or enc.ndim != 5:
            print(f"skip {path}: not a codec shard ({enc.dtype}, {enc.shape})")
            continue
        imgs = codec.decode(enc, quality=quality)
        stem = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(args.outdir, f"{stem}_rgb.npy"), imgs)
        if args.png:
            from PIL import Image

            for w in range(imgs.shape[0]):
                Image.fromarray(imgs[w]).save(os.path.join(
                    args.outdir, f"{stem}_w{w:04d}.png"))
        n += imgs.shape[0]
        print(f"{path} -> {stem}_rgb.npy {imgs.shape}")
    print(f"decode: {n} world-frames in {time.time()-t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
