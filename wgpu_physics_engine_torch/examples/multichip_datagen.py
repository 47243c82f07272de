"""Multi-device batched datagen: the port of ``examples/multichip_datagen.py``.

Cuts a batch of independent cloth worlds over a ``worlds`` mesh
(``parallel.mesh.make_mesh``) and steps and renders each shard with
``parallel.datagen.step_and_render`` under its device (K5 and the batched
sphere raster; their plain versions on the CPU), with no copies between
shards in the step; each frame's images are gathered and saved with
``np.save`` (the JAX example's native async writer is not ported yet).

    python -m wgpu_physics_engine_torch.examples.multichip_datagen \\
        [--worlds 64] [--frames 4] [--fb 64] [--shards 4] \\
        [--device cuda|cpu] [--outdir DIR]

``--shards`` shards (default 4) go round-robin over the device's cards
(``cuda:0..n-1``), so one card holds several shards and a node of four
cards one each; ``--device cpu`` makes them CPU shards. The worlds must
divide evenly over the shards. Frames go to ``--outdir`` (default
``build/multichip_datagen`` of the checkout).
"""

from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np
import torch

from ..core import config as cfg
from ..parallel import datagen, mesh as pmesh
from .. import render as R

DEFAULT_OUT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "multichip_datagen")


def shard_devices(device, n_shards: int) -> List[torch.device]:
    """``n_shards`` devices round-robin over the cards of ``device``'s
    type (the CPU is one device)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_shards
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu for CPU shards")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_shards)]


def run(n_worlds: int = 64, n_frames: int = 4, fb: int = 64,
        n_shards: int = 4, device="cuda",
        outdir: str = DEFAULT_OUT) -> List[str]:
    """Run the sharded datagen; returns the saved frame paths."""
    m = pmesh.make_mesh((n_shards,), ("worlds",),
                        shard_devices(device, n_shards))
    print(f"mesh: {m}")
    devs = m.axis_devices("worlds")
    per = n_worlds // n_shards
    if per * n_shards != n_worlds:
        raise ValueError(f"{n_worlds} worlds not divisible by {n_shards} "
                         "shards")

    c = cfg.ClothConfig(height=32, width=32)
    batch = datagen.randomized_worlds(
        c, n_worlds, torch.Generator().manual_seed(0), device="cpu")
    # the worlds axis cut over the mesh: each shard's worlds, parameters,
    # camera and texture live on its device
    shards = [datagen.WorldBatch(state=st, params=pr) for st, pr in zip(
        pmesh.shard_worlds(batch.state, m, "worlds"),
        pmesh._shard_params(batch.params, devs, per))]
    cams = {dev: R.make_camera(cfg.CameraConfig(), aspect=1.0, device=dev)
            for dev in dict.fromkeys(devs)}
    texs = {dev: datagen.globe_texture(dev) for dev in dict.fromkeys(devs)}
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for f in range(n_frames):
        imgs = []
        for d, dev in enumerate(devs):
            with pmesh._on(dev):
                shards[d], img = datagen.step_and_render(
                    shards[d], 1.0 / 480.0, 24, cams[dev], texs[dev],
                    fb_size=(fb, fb))
            imgs.append(img)
        arr = torch.cat([i.cpu() for i in imgs]).numpy()
        path = os.path.join(outdir, f"frame_{f:04d}.npy")
        np.save(path, arr)
        paths.append(path)
        print(f"frame {f}: {arr.shape} {arr.dtype} -> {path}")
    return paths


def main(argv=None) -> List[str]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", type=int, default=64)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--fb", type=int, default=64, help="frame side")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--outdir", default=DEFAULT_OUT)
    a = ap.parse_args(argv)
    return run(a.worlds, a.frames, a.fb, a.shards, a.device, a.outdir)


if __name__ == "__main__":
    main()
