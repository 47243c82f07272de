#!/usr/bin/env python3
"""Where a CTA of the cloth adjoint (``ops/csrc/cloth_grad.cu``) spends
its time, and how other tiles would do, on one CUDA card: the profilers
that count per-phase work (``ncu``, ``nsys``) do not run on every
machine, so this tool builds copies of the kernel with the source's probe
macros set and times them.

    python3 tools/adjoint_probe.py

Each copy is the repo's ``cloth_grad.cu`` built with the flags of
``ops/_build.py`` and some ``-D`` defines into
``build/adjoint_probe/<name>/`` (all in parallel), and replaces the
library for one walk over the training segment's trace (48 substeps of
the fresh 256² cloth, CUDA events, best of 5, ms a substep):

* ``kernel``: no define, the library as the package builds it;
* ``<th>x<tw> T<threads>``: the tile and CTA size of ``WPE_VJP_TILE_H``,
  ``WPE_VJP_TILE_W`` and ``WPE_VJP_THREADS``; its state and pin
  cotangents are checked bit for bit against ``kernel``'s;
* ``timed``: ``WPE_PROBE_CLOCK``, ``clock64()`` at the kernel's start and
  after each of its phases (state staged; edge forces; integration
  adjoint; edge adjoints; the core's sums), written by thread 0 of every
  CTA; the tool prints the mean and the largest cycles of each phase over
  the CTAs of one launch;
* ``empty``: ``WPE_PROBE_EMPTY``, a kernel that returns at once, the
  walk's launches and host work alone.

No copy replaces the library outside this process. Prints one JSON line
with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "wgpu_physics_engine_torch", "ops", "csrc")
OUT = os.path.join(ROOT, "build", "adjoint_probe")
MARKS = 6                                  # cloth_grad.cu kProbeMarks
MAX_TILES = 8192                           # cloth_grad.cu kProbeTiles
SCHEDULES = ((8, 32, 256), (16, 32, 512), (32, 16, 512))


def _variants() -> dict:
    """name -> (tile, -D defines)."""
    out = {"kernel": ((16, 16), [])}
    for th, tw, threads in SCHEDULES:
        out[f"{th}x{tw} T{threads}"] = ((th, tw), [
            f"-DWPE_VJP_TILE_H={th}", f"-DWPE_VJP_TILE_W={tw}",
            f"-DWPE_VJP_THREADS={threads}"])
    out["timed"] = ((16, 16), ["-DWPE_PROBE_CLOCK"])
    out["empty"] = ((16, 16), ["-DWPE_PROBE_EMPTY"])
    return out


def _build_all(variants: dict) -> dict:
    from wgpu_physics_engine_torch.ops import _build

    procs = {}
    for name, (_, defines) in variants.items():
        d = os.path.join(OUT, name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-I", SRC,
               "-o", os.path.join(d, "lib.so"),
               os.path.join(SRC, "cloth_grad.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (d, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"adjoint_probe: nvcc failed on {name}:\n"
                             f"{log[-3000:]}")
        libs[name] = os.path.join(d, "lib.so")
    return libs


def _load(path: str):
    from wgpu_physics_engine_torch.ops import cloth_grad_kernel as cg

    lib = ctypes.CDLL(path)
    for fn, argtypes in cg._SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.wpe_error_string.argtypes = [ctypes.c_int]
    lib.wpe_error_string.restype = ctypes.c_char_p
    return lib


def _best_ms(fn, reps: int = 5) -> float:
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


def main() -> int:
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("adjoint_probe: no CUDA device", file=sys.stderr)
        return 1
    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.ops import _build
    from wgpu_physics_engine_torch.ops import cloth_grad_kernel as cg
    from wgpu_physics_engine_torch.ops import cloth_kernel as ck

    variants = _variants()
    libs = _build_all(variants)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    c = ClothConfig(height=256, width=256)
    s0 = init_cloth_state(c, device=dev)
    prm = ck._pack_params(ClothParams.from_config(c, device=dev), 1 / 480)
    n = 48
    traj = ck.trace(s0, prm, n)
    g = torch.Generator().manual_seed(5)
    cp, cv = (torch.randn((3, 256, 256), generator=g).to(dev)
              for _ in range(2))
    pin = torch.zeros((256, 256), dtype=torch.bool, device=dev)
    pin[0] = True
    pins = (pin, s0.pos)
    out = {"card": card, "ms_per_substep": {}, "bitwise": {},
           "phase_cycles": {}}
    saved_lib, saved_tile = _build._LIBS.get("cloth_grad"), cg.TILE
    ref = None
    try:
        for name, path in libs.items():
            lib = _load(path)
            _build._LIBS["cloth_grad"] = lib
            cg.TILE = variants[name][0]
            out["ms_per_substep"][name] = _best_ms(
                lambda: cg._walk_kernel(traj, cp, cv, prm, None)) / n
            if name in ("timed", "empty"):
                pass
            elif ref is None:
                ref = cg._walk_kernel(traj, cp, cv, prm, pins)
            else:
                got = cg._walk_kernel(traj, cp, cv, prm, pins)
                out["bitwise"][name] = all(
                    bool(torch.equal(a, b)) for a, b in
                    ((got[0], ref[0]), (got[1], ref[1]), (got[3], ref[3])))
            if name != "timed":
                continue
            cg._walk_kernel(traj[:1], cp, cv, prm, None)
            torch.cuda.synchronize()
            buf = np.zeros((MAX_TILES, MARKS), dtype=np.int64)
            _build.check(lib, lib.wpe_probe_clock(
                ctypes.c_void_p(buf.ctypes.data)), "probe clock copy")
            tiles = -(-256 // cg.TILE[0]) * -(-256 // cg.TILE[1])
            d = np.diff(buf[:tiles].astype(np.float64), axis=1)
            out["phase_cycles"] = {
                "phases": ["staging", "edge forces", "integration adjoint",
                           "edge adjoints", "core sums"],
                "mean": [round(v) for v in d.mean(0)],
                "max": [round(v) for v in d.max(0)],
                "cta_mean": round(d.sum(1).mean())}
    finally:
        cg.TILE = saved_tile
        if saved_lib is None:
            _build._LIBS.pop("cloth_grad", None)
        else:
            _build._LIBS["cloth_grad"] = saved_lib
    out["sm_clock"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
