#!/usr/bin/env python3
"""Where the large-grid cloth kernels (``ops/csrc/cloth_tiled.cu``: K6,
K6r, K5r) spend their time, and how other CTA sizes and tiles would do,
on one CUDA card: the profilers that count per-phase work (``ncu``,
``nsys``) do not run on every machine, so this tool builds copies of the
source with its probe macros set and times them.

    python3 tools/tiled_probe.py [--quick]

Each copy is the repo's ``cloth_tiled.cu`` built with the flags of
``ops/_build.py`` and some ``-D`` defines into ``build/tiled_probe/<name>/``
(all in parallel), and replaces the library in this process only:

* ``kernel``: no define, the library as the package builds it;
* ``timed``: ``WPE_PROBE_CLOCK``: thread 0 of every CTA adds the
  ``clock64()`` cycles of each phase; the tool prints each phase's mean
  and largest cycles a CTA (K6: a launch's load and walk; K6r: its load,
  and a substep's walk, border publish, wait for the neighbours' flags and
  ring copy; K5r: a call's load and walk);
* ``nostore``: ``WPE_PROBE_NOSTORE``, K6 without its stores to device
  memory; ``empty``: ``WPE_PROBE_EMPTY``, kernels that return at once (the
  launches and host work alone);
* ``k5r T<n>`` and ``k6r T<n>``: other CTA sizes of K5r and K6r
  (``WPE_K5R_THREADS``, ``WPE_K6R_THREADS``).

Times are CUDA events, best of 5, ms a substep: K6 (``pick_schedule``) and
K6r (``resident_tile``, and the tiles of ``K6R_TILES``) over
``STEPS`` substeps of the fresh 1024² and 512² cloths; K5 (a launch a
substep) and K5r over a call of 24 substeps on ``BATCHES`` worlds of the
60×60 cloth (1,024 the datagen chunk, 64 the datagen CLI, 16 a shard of
the multi-device worlds, 132 and 264 one and two a multiprocessor). Every K6r and K5r copy is checked bit for bit against K1
(``cloth_kernel.multi_step_launch_packed``) on its shapes, and K6r also on
1000×1030 and a ragged 448×256 with pins. ``--quick`` runs only the
default library's checks and times and the CTA split of ``timed``.
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "wgpu_physics_engine_torch", "ops", "csrc")
OUT = os.path.join(ROOT, "build", "tiled_probe")
CTAS, MARKS = 8192, 6                      # cloth_tiled.cu kProbeCtas/Marks
STEPS = 240
DT = 1.0 / 480.0
DG_STEPS = 24
BATCHES = (1024, 264, 132, 64, 16)
K6R_TILES = {1024: ((94, 86), (47, 171), (147, 57), (74, 114)),
             512: ((24, 86), (37, 57), (74, 29), (47, 43))}


def _variants(quick: bool) -> dict:
    out = {"kernel": [], "timed": ["-DWPE_PROBE_CLOCK"]}
    if quick:
        return out
    out["nostore"] = ["-DWPE_PROBE_NOSTORE"]
    out["empty"] = ["-DWPE_PROBE_EMPTY"]
    for n in (256, 1024):
        out[f"k5r T{n}"] = [f"-DWPE_K5R_THREADS={n}"]
    for n in (384, 768, 1024):
        out[f"k6r T{n}"] = [f"-DWPE_K6R_THREADS={n}"]
    return out


def _build_all(variants: dict) -> dict:
    from wgpu_physics_engine_torch.ops import _build

    procs = {}
    for name, defines in variants.items():
        d = os.path.join(OUT, name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *defines, "-I", SRC,
               "-o", os.path.join(d, "lib.so"),
               os.path.join(SRC, "cloth_tiled.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs, ptxas = {}, {}
    for name, (d, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"tiled_probe: nvcc failed on {name}:\n"
                             f"{log[-4000:]}")
        libs[name] = os.path.join(d, "lib.so")
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    return libs, ptxas


def _load(path: str):
    from wgpu_physics_engine_torch.ops import cloth_tiled_kernel as ctk

    lib = ctypes.CDLL(path)
    for fn, argtypes in ctk._SIGNATURES.items():
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


def _equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel))


def _clock(lib, n_ctas: int, phases):
    """Mean and largest cycles of each phase a CTA since the last read."""
    import numpy as np

    buf = np.zeros((CTAS, MARKS), dtype=np.int64)
    err = lib.wpe_probe_clock(ctypes.c_void_p(buf.ctypes.data))
    if err:
        raise SystemExit(f"tiled_probe: probe clock copy failed ({err})")
    d = buf[:n_ctas, :len(phases)].astype(np.float64)
    return {"phases": list(phases), "mean": [round(v) for v in d.mean(0)],
            "max": [round(v) for v in d.max(0)]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("tiled_probe: no CUDA device", file=sys.stderr)
        return 1
    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.ops import _build
    from wgpu_physics_engine_torch.ops import cloth_kernel as ck
    from wgpu_physics_engine_torch.ops import cloth_tiled_kernel as ctk
    from wgpu_physics_engine_torch.parallel import datagen

    variants = _variants(args.quick)
    libs, ptxas = _build_all(variants)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    sms = ctk.sm_count(dev)

    grids = {}
    for side in (1024, 512):
        c = ClothConfig(height=side, width=side)
        grids[side] = (init_cloth_state(c, device=dev),
                       ClothParams.from_config(c, device=dev))
    checks = {}
    for h, w in ((1000, 1030), (448, 256)):
        c = ClothConfig(height=h, width=w)
        s = init_cloth_state(c, device=dev)
        pin = torch.zeros((h, w), dtype=torch.bool, device=dev)
        pin[0] = True
        pin[h // 2, w // 3] = True
        g = torch.Generator().manual_seed(h)
        s = s._replace(vel=(0.5 * torch.randn((3, h, w), generator=g)).to(dev),
                       pin_mask=pin, pin_pos=s.pos)
        checks[(h, w)] = (s, ClothParams.from_config(c, device=dev))
    worlds = datagen.randomized_worlds(
        ClothConfig(), 1024, torch.Generator().manual_seed(0), device=dev)
    pin = torch.zeros((1024, 60, 60), dtype=torch.bool, device=dev)
    pin[:, 0] = True
    batches = {n: worlds.state._replace(
        pos=worlds.state.pos[:n], vel=worlds.state.vel[:n])
        for n in BATCHES}
    pinned = worlds.state._replace(pin_mask=pin, pin_pos=worlds.state.pos)
    wprm = ck._pack_params(worlds.params, DT)

    def k1(state, prm, n):
        return ck.multi_step_launch_packed(state, prm, n)

    refs = {}
    for side, (s, p) in grids.items():
        refs[side] = k1(s, ck._pack_params(p, DT), 13)
        refs[(side, 8)] = k1(s, ck._pack_params(p, DT), 8)
    for hw, (s, p) in checks.items():
        refs[hw] = k1(s, ck._pack_params(p, DT), 13)
    refs["worlds"] = k1(pinned, wprm, DG_STEPS)

    out = {"card": card, "sms": sms, "ptxas": ptxas, "ms_per_substep": {},
           "bitwise": {}, "phase_cycles": {},
           "resident_tiles": {str(s): ctk.resident_tile(s, s, dev)
                              for s in (512, 1024)}}
    ms, bitwise = out["ms_per_substep"], out["bitwise"]
    saved = _build._LIBS.get("cloth_tiled")
    try:
        for name, path in libs.items():
            lib = _load(path)
            _build._LIBS["cloth_tiled"] = lib
            probe = name in ("timed", "nostore", "empty")
            if name == "kernel" or probe:
                for side, (s, p) in grids.items():
                    ms[f"{name} k6 {side}"] = _best_ms(
                        lambda: ctk.multi_step_kernel(s, p, DT, STEPS)) / STEPS
            if name == "timed":
                s, p = grids[1024]
                _clock(lib, CTAS, ("load",))                  # clear
                ctk.multi_step_kernel(s, p, DT, STEPS)
                torch.cuda.synchronize()
                _, th, tw = ctk.pick_schedule(1024, 1024, STEPS, sms)
                n_ctas = -(-1024 // th) * -(-1024 // tw)
                out["phase_cycles"]["k6 1024, a launch"] = {
                    k_: ([round(v / STEPS) for v in vals]
                         if k_ != "phases" else vals)
                    for k_, vals in _clock(lib, n_ctas,
                                           ("load", "walk")).items()}
            if name.startswith("k5r") or name in ("kernel", "timed", "empty"):
                for n, st in batches.items():
                    ms[f"{name} k5r {n}"] = _best_ms(
                        lambda: ctk.multi_step_batched_kernel_packed(
                            st, wprm[:n], DG_STEPS)) / DG_STEPS
                if not probe:
                    bitwise[f"{name} k5r"] = _equal(
                        ctk.multi_step_batched_kernel_packed(
                            pinned, wprm, DG_STEPS), refs["worlds"])
                if name == "timed":
                    _clock(lib, CTAS, ("load", "walk"))      # clear
                    ctk.multi_step_batched_kernel_packed(batches[1024],
                                                         wprm, DG_STEPS)
                    torch.cuda.synchronize()
                    out["phase_cycles"]["k5r 1024 worlds, a call"] = _clock(
                        lib, 1024, ("load", "walk"))
            if name.startswith("k6r") or name in ("kernel", "timed", "empty"):
                for side, (s, p) in grids.items():
                    tiles = ((None,) if probe or name != "kernel"
                             else (None,) + K6R_TILES[side])
                    for tile in tiles:
                        key = f"{name} k6r {side}" + (
                            "" if tile is None else f" {tile[0]}x{tile[1]}")
                        ms[key] = _best_ms(
                            lambda: ctk.multi_step_resident_kernel(
                                s, p, DT, STEPS, tile)) / STEPS
                        if not probe:
                            bitwise[key] = _equal(
                                ctk.multi_step_resident_kernel(
                                    s, p, DT, 13, tile), refs[side])
                if not probe:
                    for side, (s, p) in grids.items():
                        bitwise[f"{name} k6r {side} n=8"] = _equal(
                            ctk.multi_step_resident_kernel(s, p, DT, 8),
                            refs[(side, 8)])
                    for hw, (s, p) in checks.items():
                        bitwise[f"{name} k6r {hw[0]}x{hw[1]}"] = _equal(
                            ctk.multi_step_resident_kernel(s, p, DT, 13),
                            refs[hw])
                if name == "timed":
                    s, p = grids[1024]
                    _clock(lib, CTAS, ("load",))              # clear
                    ctk.multi_step_resident_kernel(s, p, DT, STEPS)
                    torch.cuda.synchronize()
                    th, tw = ctk.resident_tile(1024, 1024, dev)
                    n_ctas = -(-1024 // th) * -(-1024 // tw)
                    c = _clock(lib, n_ctas, ("load", "walk", "publish",
                                             "wait", "ring", "store"))
                    per = STEPS, STEPS, STEPS - 1, STEPS - 1, STEPS - 1, 1
                    out["phase_cycles"][name + " k6r 1024, a substep"] = {
                        "phases": c["phases"],
                        "mean": [round(v / n) for v, n in zip(c["mean"], per)],
                        "max": [round(v / n) for v, n in zip(c["max"], per)]}
            if name == "kernel":
                for n, st in batches.items():
                    ms[f"k5 {n}"] = _best_ms(lambda: ck.multi_step_launch_packed(
                        st, wprm[:n], DG_STEPS)) / DG_STEPS
                for side, (s, p) in grids.items():
                    ms[f"k1 {side}"] = _best_ms(lambda: ck.multi_step_launch_packed(
                        s, ck._pack_params(p, DT), STEPS)) / STEPS
    finally:
        if saved is None:
            _build._LIBS.pop("cloth_tiled", None)
        else:
            _build._LIBS["cloth_tiled"] = saved
    out["sm_clock"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
