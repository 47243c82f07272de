#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the flagship scene, a 256×256 mass-spring
cloth over the lit, textured globe, stepped 5 simulated seconds (2,400
substeps at 480 Hz) and rendered at 256×256 — through the entry points a
user calls (``ClothScene.simulate``/``render`` and the CLI), after
building its two hand-written CUDA kernels from ``ops/csrc`` and holding
each against its plain torch version on the card. Phases:

1. the card: CUDA present, ``nvidia-smi`` name and power limit;
2. the build of both kernels (nvcc, timed);
3. the cloth kernel vs its plain version at 256² with the top row pinned:
   1 substep <= 1e-6 abs, 240 substeps <= 1e-5 on pos, fast_math vs the
   exact path <= 1e-4 after 330 substeps, and the fast_math kernel within
   1e-6 of its fast plain version;
4. the sphere-raster kernel vs its plain version on the 65,536 instances
   of phase 3's 240-substep state, at 256×256 and at a ragged 800×1200:
   ``hit`` identical on >= 99.99% of pixels, the same winner on >= 99.99%
   of hit pixels, ``tmin`` <= 1e-6 wherever both hit and ``oc`` <= 1e-6
   where the winner agrees, misses exactly (+inf, 0);
5. the main path, with the kernel launch counters reset just before it and
   read just after: finite state resting on the globe (r_min within 1e-3
   of R + r), the ensemble contract against the plain version's run of the
   same scene (mean/min radius 1e-3 relative, mean height 2e-3 relative),
   and an image with both globe and particle pixels;
6. times on the card (CUDA events, best of 3 after a warm-up) of each
   kernel and its plain version, and of one whole frame;
7. where the time goes (PERF.md section 5): the raster's candidates per
   tile, the spread of repeated timings, and one ``torch.profiler`` trace
   each of 240 substeps and of one frame, read for the kernel time per
   launch, the gaps between launches and the device's idle share.

Any failed check raises, so the script exits non-zero; with no CUDA device
it exits non-zero before doing anything. The next-to-last line of stdout is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Images and the full results go to ``chiprun_out/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out")
HZ = 480.0
DT = 1.0 / HZ
# the flagship configuration: cloth grid side, main frame, ragged frame,
# and substeps timed in phase 6
GRID = 256
FRAME = (256, 256)
RAGGED = (800, 1200)
N_TIME = 3000


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _maxdiff(a, b) -> float:
    return float((a - b).abs().max())


def _best_ms(fn, reps: int = 3) -> float:
    """Best of ``reps`` timed calls after one warm-up, CUDA events."""
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


def _union_us(spans) -> float:
    """Length of the union of ``(start, end)`` spans."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (hi - lo if hi is not None else 0.0)


def _trace(fn, path):
    """Run ``fn`` once under ``torch.profiler`` (host and device), write the
    Chrome trace to ``path`` and return its device spans ``(start, end,
    name)`` and host spans ``(start, end)``, in µs on one clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [(e["ts"], e["ts"] + e["dur"]) for e in spans
            if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation")]
    _check(bool(dev) and bool(host), f"trace {path}: no device or host spans")
    return dev, host


def _profile(scene, params, wins, card) -> dict:
    """The breakdown of PERF.md section 5, from this run alone: the raster's
    per-tile load, the spread of repeated timings, and one torch.profiler
    trace each of 240 substeps and of one frame (traces to chiprun_out/)."""
    import torch

    from wgpu_physics_engine_torch.core.state import init_cloth_state
    from wgpu_physics_engine_torch.ops import cloth_kernel

    fh, fw = FRAME
    res = {"card": card}
    w = wins.long()
    cand = sum(w[:, 2 * g + 1] - w[:, 2 * g] for g in range(4))
    res["tiles"] = {"n": int(w.shape[0]), "cand_mean": float(cand.float().mean()),
                    "cand_max": int(cand.max()), "global": int(w[0, 7] - w[0, 6])}
    print(f"phase 7 raster tiles @{fh}x{fw}: {res['tiles']['n']} tiles, "
          f"candidates per tile mean {res['tiles']['cand_mean']:.1f} max "
          f"{res['tiles']['cand_max']} (global range {res['tiles']['global']})")

    s_free = init_cloth_state(scene.config, device=scene.device)
    k1 = [_best_ms(lambda: cloth_kernel.multi_step_kernel(
        s_free, params, DT, N_TIME), reps=1) / N_TIME for _ in range(7)]
    host = {}
    for hw, reps in ((FRAME, 7), (RAGGED, 4)):
        scene.render(*hw)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            scene.render(*hw)            # ends in a copy to the host
            ts.append((time.perf_counter() - t0) * 1e3)
        host[f"{hw[0]}x{hw[1]}"] = ts
    res["spread"] = {"cloth_ms_per_substep": k1, "frame_host_ms": host}
    print(f"phase 7 spread [{card}]: cloth {N_TIME} substeps x 7 calls "
          f"{min(k1):.6f}-{max(k1):.6f} ms/substep (CUDA events); frame host "
          f"clock " + ", ".join(f"{k} {min(v):.3f}-{max(v):.3f} ms ({len(v)} "
                                f"runs)" for k, v in host.items()))

    dev, _ = _trace(lambda: cloth_kernel.multi_step_kernel(
        s_free, params, DT, 240), os.path.join(OUT, "trace_substeps.json"))
    sub = [(a, b) for a, b, name in dev if "substep_kernel" in name]
    _check(len(sub) == 240, f"trace shows {len(sub)} substep kernels, not 240")
    span = max(b for _, b in sub) - min(a for a, _ in sub)
    busy = _union_us(sub)
    res["substeps_240"] = {"kernel_us": busy / len(sub), "span_us": span,
                           "busy_share": busy / span,
                           "gap_us": (span - busy) / (len(sub) - 1)}
    print(f"phase 7 trace 240 substeps [{card}]: {busy / len(sub):.3f} us of "
          f"kernel time per launch, span {span:.1f} us, device busy "
          f"{busy / span:.4f} of it, mean gap {(span - busy) / 239:.3f} us")

    dev, host_spans = _trace(lambda: scene.render(fh, fw),
                             os.path.join(OUT, "trace_frame.json"))
    t0 = min([a for a, _ in host_spans] + [a for a, _, _ in dev])
    t1 = max([b for _, b in host_spans] + [b for _, b, _ in dev])
    busy = _union_us([(a, b) for a, b, _ in dev])
    raster = sum(b - a for a, b, name in dev if "sphere_raster" in name)
    res["frame"] = {"window_us": t1 - t0, "device_busy_us": busy,
                    "raster_us": raster, "device_ops": len(dev),
                    "idle_share": 1.0 - busy / (t1 - t0)}
    print(f"phase 7 trace one frame {fh}x{fw} [{card}]: window {t1 - t0:.1f} "
          f"us (host, profiled), device busy {busy:.1f} us in {len(dev)} "
          f"device ops, of which the raster kernel {raster:.1f} us; device "
          f"idle share {1.0 - busy / (t1 - t0):.4f}")
    return res


def main() -> int:
    import torch

    # ---- phase 1: the card ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on "
              "the card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1 card: {card} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | devices {torch.cuda.device_count()}")

    sys.path.insert(0, HERE)
    from wgpu_physics_engine_torch.core.config import CameraConfig, ClothConfig
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)
    from wgpu_physics_engine_torch.models.scenes import ClothScene
    from wgpu_physics_engine_torch.ops import _build, cloth_kernel, raster_kernel
    from wgpu_physics_engine_torch.render import camera as cam_mod
    from wgpu_physics_engine_torch.utils import viewer
    from wgpu_physics_engine_torch.__main__ import main as cli_main

    os.makedirs(OUT, exist_ok=True)
    results = {"card": card}

    # ---- phase 2: build both kernels from the checkout's sources ----
    t0 = time.time()
    _build.load("cloth_step", cloth_kernel._SIGNATURES)
    t1 = time.time()
    _build.load("sphere_raster", raster_kernel._SIGNATURES)
    t2 = time.time()
    results["build_s"] = {"cloth_step": t1 - t0, "sphere_raster": t2 - t1}
    print(f"phase 2 build: cloth_step {t1 - t0:.2f} s, sphere_raster "
          f"{t2 - t1:.2f} s (nvcc {_build.nvcc_path()})")
    for name in ("cloth_step", "sphere_raster"):
        with open(os.path.join(_build.lib_dir(name), "build.log")) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    # ---- phase 3: the cloth kernel vs its plain version, 256² pinned ----
    cfg = ClothConfig(height=GRID, width=GRID)
    params = ClothParams.from_config(cfg, device=dev)
    s0 = init_cloth_state(cfg, device=dev)
    pin = torch.zeros((GRID, GRID), dtype=torch.bool, device=dev)
    pin[0] = True
    s0 = s0._replace(pin_mask=pin, pin_pos=s0.pos)
    k1 = cloth_kernel.multi_step_kernel(s0, params, DT, 1)
    p1 = cloth_kernel.multi_step_plain(s0, params, DT, 1)
    e1 = max(_maxdiff(k1.pos, p1.pos), _maxdiff(k1.vel, p1.vel))
    k240 = cloth_kernel.multi_step_kernel(s0, params, DT, 240)
    p240 = cloth_kernel.multi_step_plain(s0, params, DT, 240)
    e240 = _maxdiff(k240.pos, p240.pos)
    e240v = _maxdiff(k240.vel, p240.vel)
    fast = cloth_kernel.multi_step_kernel(s0, params, DT, 330, fast_math=True)
    exact = cloth_kernel.multi_step_plain(s0, params, DT, 330)
    fast_p = cloth_kernel.multi_step_plain(s0, params, DT, 330, fast_math=True)
    ef = _maxdiff(fast.pos, exact.pos)
    efp = _maxdiff(fast.pos, fast_p.pos)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(k240.pos, p240.pos)
                   and torch.equal(k240.vel, p240.vel))
    print(f"phase 3 cloth_step vs plain @{GRID}x{GRID} pinned: 1 substep "
          f"{e1:.3e} (<=1e-6), 240 substeps pos {e240:.3e} (<=1e-5) vel "
          f"{e240v:.3e}, bitwise {bitwise}; fast_math vs exact after 330 "
          f"{ef:.3e} (<=1e-4), fast kernel vs fast plain {efp:.3e}")
    _check(e1 <= 1e-6, f"cloth 1 substep diff {e1}")
    _check(e240 <= 1e-5, f"cloth 240 substeps diff {e240}")
    _check(ef <= 1e-4, f"cloth fast_math diff {ef}")
    _check(efp <= 1e-6, f"cloth fast_math kernel vs fast plain diff {efp}")
    _check(torch.equal(k240.pos[:, 0], s0.pos[:, 0]), "pinned row moved")
    _check(bool(torch.isfinite(k240.pos).all()), "cloth state not finite")
    results["cloth_step"] = {"err_1": e1, "err_240_pos": e240,
                             "err_240_vel": e240v, "bitwise_240": bitwise,
                             "err_fast_vs_exact_330": ef,
                             "err_fast_vs_fast_plain_330": efp}

    # ---- phase 4: the raster kernel vs its plain version, 65,536 inst ----
    centers = k240.pos.reshape(3, -1).T
    look = CameraConfig(target=(0.0, 38.0, 0.0), radius=45.0, phi=0.6)
    r_err, r_cases = 0.0, {}
    for h, w in (FRAME, RAGGED):
        cam = cam_mod.make_camera(look, aspect=w / h, device=dev)
        eye, dirs = cam_mod.pixel_rays(cam, h, w)
        wins, ocb, _ = raster_kernel.tiled_prologue(
            cam.view[:3, :3], eye, centers, cfg.particle_radius, cam.znear,
            torch.tan(cam.fovy_rad / 2.0), cam.aspect, h, w)
        kt, ki, ko = raster_kernel.sphere_raster_kernel(wins, ocb, dirs,
                                                        cam.znear)
        pt, pi, po = raster_kernel.sphere_raster_plain(ocb, dirs, cam.znear)
        torch.cuda.synchronize()
        hit_k, hit_p = ki >= 0, pi >= 0
        agree = float((hit_k == hit_p).float().mean())
        both = hit_k & hit_p
        same = (ki == pi) & hit_k
        n_hit = int(hit_k.sum())
        n_same = int(same.sum())
        # tmin on every pixel both sides hit, whoever won; oc where the
        # winner agrees; misses must be exactly (+inf, 0) on both sides
        et = _maxdiff(kt[both], pt[both]) if bool(both.any()) else 0.0
        eo = _maxdiff(ko[:, same], po[:, same]) if n_same else 0.0
        miss = ~hit_k
        miss_ok = bool(torch.isinf(kt[miss]).all()
                       and (ko[:, miss] == 0).all())
        bitwise = bool(torch.equal(ki, pi) and torch.equal(kt, pt)
                       and torch.equal(ko, po))
        print(f"phase 4 sphere_raster vs plain @{h}x{w}, {GRID * GRID} "
              f"instances: hit agree {agree:.6f} (>=0.9999), hits {n_hit}, "
              f"same winner {n_same} (>=0.9999 of hits), tmin {et:.3e} "
              f"oc {eo:.3e} (<=1e-6), bitwise {bitwise}")
        _check(n_hit > 0.05 * h * w, f"raster {h}x{w}: only {n_hit} hits")
        _check(agree >= 0.9999, f"raster {h}x{w} hit agreement {agree}")
        _check(n_same >= 0.9999 * n_hit,
               f"raster {h}x{w}: winner agrees on {n_same} of {n_hit} hits")
        _check(et <= 1e-6 and eo <= 1e-6, f"raster {h}x{w} diff {et} {eo}")
        _check(miss_ok, f"raster {h}x{w}: a miss is not (+inf, 0)")
        r_err = max(r_err, et, eo)
        r_cases[f"{h}x{w}"] = {"hit_agree": agree, "hits": n_hit,
                               "same_winner": n_same, "err_tmin": et,
                               "err_oc": eo, "bitwise": bitwise}
    results["sphere_raster"] = r_cases

    # ---- phase 5: the main path, counted ----
    fh, fw = FRAME
    scene = ClothScene(cfg, device=dev)
    scene.resize(fw, fh)
    cli_png = os.path.join(OUT, "cloth_cli.png")
    torch.cuda.synchronize()
    cloth_kernel.LAUNCHES = 0
    raster_kernel.LAUNCHES = 0
    t0 = time.time()
    scene.simulate(5.0)
    torch.cuda.synchronize()
    sim_s = time.time() - t0
    img = scene.render(fh, fw)
    rc = cli_main(["cloth", "--grid", str(GRID), "--size", str(fh), str(fw),
                   "--seconds", "5", "--out", cli_png, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"cloth_step": cloth_kernel.LAUNCHES,
                "sphere_raster": raster_kernel.LAUNCHES}
    print(f"phase 5 main path: ClothScene {GRID}x{GRID} simulate(5.0) "
          f"{sim_s:.3f} s host clock + render{FRAME} + CLI (rc {rc}); launches "
          f"{launches}")
    _check(rc == 0, f"CLI returned {rc}")
    _check(launches["cloth_step"] > 0 and launches["sphere_raster"] > 0,
           f"a kernel of the main path never launched: {launches}")
    viewer.save_png(img, os.path.join(OUT, "cloth.png"))

    pos = scene.state.pos
    _check(bool(torch.isfinite(pos).all()), "main-path state not finite")
    r = torch.linalg.norm(pos, dim=0)
    r_min_exp = cfg.globe_radius + cfg.particle_radius
    _check(abs(float(r.min()) - r_min_exp) <= 1e-3,
           f"r_min {float(r.min())} not at {r_min_exp}")
    ref = cloth_kernel.multi_step_plain(
        init_cloth_state(cfg, device=dev), scene.params, DT, 2400)
    rr = torch.linalg.norm(ref.pos, dim=0)
    stats = {
        "r_mean": (float(r.mean()), float(rr.mean())),
        "r_min": (float(r.min()), float(rr.min())),
        "y_mean": (float(pos[1].mean()), float(ref.pos[1].mean())),
    }
    rel = {k: abs(a - b) / abs(b) for k, (a, b) in stats.items()}
    print(f"phase 5 drape: kernel vs plain run {stats}; relative {rel} "
          f"(r 1e-3, y 2e-3)")
    _check(rel["r_mean"] <= 1e-3 and rel["r_min"] <= 1e-3,
           f"radius statistics off: {rel}")
    _check(rel["y_mean"] <= 2e-3, f"mean height off: {rel}")
    bg = torch.tensor([0.05, 0.05, 0.08])
    t_img = torch.from_numpy(img)
    red = int((t_img == torch.tensor([1.0, 0.0, 0.0])).all(-1).sum())
    n_bg = int(((t_img - bg).abs().amax(-1) < 1e-6).sum())
    globe = fh * fw - red - n_bg
    print(f"phase 5 image {fh}x{fw}: particle px {red}, globe px {globe}, "
          f"background px {n_bg}")
    _check(bool(torch.isfinite(t_img).all()), "image not finite")
    _check(red > 100 and globe > 100, f"image lacks globe/particles: "
           f"{red} {globe}")
    results["main_path"] = {"launches": launches, "simulate_s": sim_s,
                            "stats": stats, "rel": rel, "particle_px": red,
                            "globe_px": globe}

    # ---- phase 6: times on the card ----
    n = N_TIME
    s_free = init_cloth_state(cfg, device=dev)
    k_ms = _best_ms(lambda: cloth_kernel.multi_step_kernel(s_free, params,
                                                           DT, n))
    p_ms = _best_ms(lambda: cloth_kernel.multi_step_plain(s_free, params,
                                                          DT, n))
    k_rate = GRID * GRID * n / (k_ms / 1e3)
    p_rate = GRID * GRID * n / (p_ms / 1e3)
    print(f"phase 6 cloth {GRID}x{GRID} x {n} substeps [{card}]: kernel "
          f"{k_ms / n:.5f} ms/substep = {k_rate:.4e} particle-steps/s; plain "
          f"{p_ms / n:.5f} ms/substep = {p_rate:.4e} particle-steps/s")

    cam = scene.camera()
    eye, dirs = cam_mod.pixel_rays(cam, fh, fw)
    c_main = scene.state.pos.reshape(3, -1).T
    wins, ocb, _ = raster_kernel.tiled_prologue(
        cam.view[:3, :3], eye, c_main, cfg.particle_radius, cam.znear,
        torch.tan(cam.fovy_rad / 2.0), cam.aspect, fh, fw)
    rk_ms = _best_ms(lambda: raster_kernel.sphere_raster_kernel(
        wins, ocb, dirs, cam.znear))
    rp_ms = _best_ms(lambda: raster_kernel.sphere_raster_plain(
        ocb, dirs, cam.znear))
    frame_ms = _best_ms(lambda: scene.render(fh, fw))
    print(f"phase 6 render {fh}x{fw}, {GRID * GRID} instances [{card}]: raster kernel "
          f"{rk_ms:.4f} ms, raster plain {rp_ms:.4f} ms; whole frame "
          f"(kernel path, incl. prologue, globe, copy to host) "
          f"{frame_ms:.4f} ms")
    results["times"] = {"cloth_kernel_ms_per_substep": k_ms / n,
                        "cloth_plain_ms_per_substep": p_ms / n,
                        "cloth_kernel_psteps_per_s": k_rate,
                        "cloth_plain_psteps_per_s": p_rate,
                        "raster_kernel_ms": rk_ms, "raster_plain_ms": rp_ms,
                        "frame_ms": frame_ms}

    # ---- phase 7: where the time goes ----
    results["profile"] = _profile(scene, params, wins, card)
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)

    kernels = [
        {"name": "cloth_step", "route": "cuda",
         "source": "wgpu_physics_engine_torch/ops/csrc/cloth_step.cu",
         "replaces": "wgpu_physics_engine_tpu/ops/cloth_pallas.py:195",
         "launches": launches["cloth_step"],
         "max_abs_err": max(e1, e240, efp), "ms": k_ms / n,
         "plain_ms": p_ms / n},
        {"name": "sphere_raster", "route": "cuda",
         "source": "wgpu_physics_engine_torch/ops/csrc/sphere_raster.cu",
         "replaces": "wgpu_physics_engine_tpu/ops/raster_pallas.py:209",
         "launches": launches["sphere_raster"],
         "max_abs_err": r_err, "ms": rk_ms, "plain_ms": rp_ms},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
