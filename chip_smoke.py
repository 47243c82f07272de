#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two paths through the entry points a user calls, after
building the hand-written CUDA kernels from ``ops/csrc`` and holding each
against its plain torch version on the card: the flagship scene, a
256×256 mass-spring cloth over the lit, textured globe, stepped 5
simulated seconds (2,400 substeps at 480 Hz) and rendered at 256×256
(``ClothScene.simulate``/``render`` and the CLI); and batched datagen,
4,096 worlds of the 60×60 reference cloth stepped and rendered to 256×256
frames and compressed (``generate_trajectory_dataset`` and the CLI's
``datagen``/``decode``). Phases:

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
   launch, the gaps between launches and the device's idle share;
8. the batched-worlds cloth kernel (K5) on 4096 worlds of the 60×60
   reference cloth with per-world parameters, 24 substeps, free and with
   the top row pinned, first fresh (in free fall) and then settled 3 s on
   the globe (where the contact, friction and projection branches run:
   the shares of particles in contact and projected are reported and must
   be above zero): against its plain version and against the
   single-world kernel on worlds 0, 1 and 4095 (<= 1e-6, bitwise
   reported), finite, 24 launches;
9. one batched raster launch on a chunk of 1,024 settled worlds (the
   datagen path's launch) at 256×256 against the plain sweep on worlds 0,
   511 and 1,023, under phase 4's contract;
10. the datagen path, with the launch counters reset just before it and
   read just after: ``generate_trajectory_dataset`` over 4096 settled
   worlds, 3 frames of 24 substeps at 256×256, randomized cameras, codec
   k = 16, then the CLI's ``datagen`` and ``decode``; cloth and globe
   pixels in >= 90% of worlds, the yielded frame 0 equal to the codec of
   the raw frame 0 (its decoded PSNR reported), the codec >= 28 dB mean
   PSNR on the worlds' cached globes; on 16 worlds, the kernel path's
   frames equal to the same path's with the plain stepper and sweep, and
   within uint8 1 of ``use_kernel=False`` on >= 99.9% of the pixels.

Then phases 6 and 7 for the datagen path: K5 per call beside its plain
version and bound, phase 9's raster launch, one steady frame of
4,096 worlds with and without the codec, the copy into pinned memory, and
one ``torch.profiler`` trace of a frame split into K5, raster, composite,
codec and copy with the device's idle share.

Any failed check raises, so the script exits non-zero; with no CUDA device
it exits non-zero before doing anything. The next-to-last line of stdout is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
Images and the full results go to ``chiprun_out/``.
"""

from __future__ import annotations

import contextlib
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
# the datagen slice (BASELINE.json configs[4]): worlds of the 60x60
# reference cloth, substeps a frame, frame size, codec coefficients, worlds
# per chunk (four chunks bound the eager composite's temporaries), seed,
# and the substeps (3 s) that drop the fresh worlds onto the globe before
# phase 9, so that the randomized views (aimed at the globe) see the cloth
DG_WORLDS = 4096
DG_STEPS = 24
DG_FB = (256, 256)
DG_K = 16
DG_CHUNK = 1024
DG_SEED = 0
DG_SETTLE = 1440
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 FLOP/s (no tensor
# cores)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# fp32 operations of the cloth function: per spring edge and substep 28
# for the edge force (difference 3, squared length 5, sqrt and reciprocal
# 2, unit vector 3, stretch 1, relative velocity along it 8, force 3,
# components 3) and 6 to add it to both ends; per particle and substep 82
# (gravity 2, globe distance 7, normal 3, penalty 2 + 6, normal force 5,
# tangent 6, its length 7, friction 3 + 9, 1/m 1, velocity 12, position 6,
# projection 7 + 6, counted once for every particle)
OPS_EDGE = 34
OPS_PARTICLE = 82
# per (pixel, candidate) of the sphere sweep: b 5, disc 2, t 3, tests 3
OPS_RAY_SPHERE = 13


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


def _bound(nbytes: float, ops: float):
    """The least time (ms) the card could take: the larger of the bytes over
    HBM bandwidth and the fp32 operations over the fp32 peak, and which."""
    tb, to = nbytes / HBM_BPS * 1e3, ops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _cloth_bound(h: int, w: int, n_worlds: int, n_steps: int):
    """Bound of one cloth call: pos and vel read once and written once
    (48 B a particle), and the operations of every substep."""
    from wgpu_physics_engine_torch.ops.cloth_kernel import _FAMILIES

    edges = sum((h - dr) * (w - abs(dc)) for dr, dc, _ in _FAMILIES)
    ops = n_worlds * n_steps * (OPS_EDGE * edges + OPS_PARTICLE * h * w)
    return _bound(48.0 * n_worlds * h * w, ops)


def _raster_bound(wins, n: int, h: int, w: int):
    """Bound of one raster call over ``wins`` ([T, 8] or [B, T, 8]): rays in
    (12 B a pixel), the sorted table and the ranges in, tmin, winner and
    centre out (20 B a pixel); the sweep of every pixel of a tile over the
    candidates in that tile's four ranges, as this run's data bins them."""
    from wgpu_physics_engine_torch.ops.raster_kernel import TILE_H, TILE_W

    w8 = wins.reshape(-1, wins.shape[-2], 8).long()
    ty, tx = -(-h // TILE_H), -(-w // TILE_W)
    rows = [min(TILE_H, h - TILE_H * i) for i in range(ty)]
    cols = [min(TILE_W, w - TILE_W * j) for j in range(tx)]
    px = [r * c for r in rows for c in cols]                 # pixels a tile
    cand = sum(w8[..., 2 * g + 1] - w8[..., 2 * g] for g in range(4))
    import torch

    sweeps = float((cand.double() * torch.tensor(px, dtype=torch.float64,
                                                 device=cand.device)).sum())
    b = w8.shape[0]
    nbytes = b * (32.0 * h * w + 16.0 * n + 32.0 * ty * tx + 4.0)
    return _bound(nbytes, OPS_RAY_SPHERE * sweeps)


def _dg_setup(settled, seed: int, dev):
    """The set-up of a datagen run from ``worlds=settled`` and a generator
    seeded ``seed``, by the generator's own code: the globe texture and
    ``(batches, cameras, cached globes)`` per chunk."""
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.parallel import datagen

    tex = datagen.globe_texture(dev)
    return tex, datagen.world_chunks(
        ClothConfig(), DG_WORLDS, tex, torch.Generator().manual_seed(seed),
        DG_FB, world_chunk=DG_CHUNK, randomize_cameras=True, worlds=settled,
        device=dev)


def _dg_frame(tex, chunks, codec_k):
    """One steady frame of every chunk (``datagen.frame_parts``, the
    generator's frame); the chunks advance in place."""
    from wgpu_physics_engine_torch.parallel import datagen

    return datagen.frame_parts(*chunks, DT, DG_STEPS, tex, DG_FB,
                               codec_k=codec_k)


@contextlib.contextmanager
def _plain_wrappers():
    """Inside, the cloth and raster kernels' wrappers run their plain
    versions on the card (and count no launch), so a datagen run goes
    through the path's own code with the plain stepper and sweep."""
    from wgpu_physics_engine_torch.ops import cloth_kernel, raster_kernel

    saved = cloth_kernel.multi_step_kernel, raster_kernel.sphere_raster_kernel
    cloth_kernel.multi_step_kernel = (
        lambda s, p, dt, n, fast_math=False:
        cloth_kernel.multi_step_plain(s, p, dt, n, fast_math))
    raster_kernel.sphere_raster_kernel = (
        lambda wins, ocb, dirs, znear:
        raster_kernel.sphere_raster_plain(ocb, dirs, znear))
    try:
        yield
    finally:
        cloth_kernel.multi_step_kernel, raster_kernel.sphere_raster_kernel = saved


def _classify(img):
    """Per world of uint8 frames [B, H, W, 3]: (particle pixels, globe
    pixels) — particles are flat red, the background the clear colour."""
    import torch

    red = (img == torch.tensor([255, 0, 0], dtype=torch.uint8,
                               device=img.device)).all(-1)
    bg = (img == torch.tensor([13, 13, 20], dtype=torch.uint8,
                              device=img.device)).all(-1)
    return red.sum((1, 2)), (~red & ~bg).sum((1, 2))


def _phase8_k5(wb, label: str, dev, card, need_contact: bool):
    """K5 on the card: the 4096 60x60 worlds ``wb`` with per-world params,
    24 substeps, free and with the top row pinned, against its plain
    version and against K1 on worlds 0, 1 and 4095. Reports the share of
    particles that start a substep inside the globe's contact distance
    (the penalty and friction branches) and that end projected onto it
    (zero velocity); with ``need_contact`` both must be above zero."""
    import torch

    from wgpu_physics_engine_torch.core.state import ClothParams, ClothState
    from wgpu_physics_engine_torch.ops import cloth_kernel

    res, err = {}, 0.0
    min_dist = cloth_kernel._pack_params(wb.params, DT)[:, 14, None, None]
    x, y, z = wb.state.pos.unbind(1)
    dist = torch.sqrt(x * x + y * y + z * z)
    contact = float((dist < min_dist).float().mean())
    pin = torch.zeros(wb.state.pos.shape[:1] + wb.state.pos.shape[2:],
                      dtype=torch.bool, device=dev)
    pin[:, 0] = True
    for case, state in (("free", wb.state),
                        ("pinned", wb.state._replace(pin_mask=pin,
                                                     pin_pos=wb.state.pos))):
        cloth_kernel.LAUNCHES_BATCHED = 0
        k5 = cloth_kernel.multi_step_kernel(state, wb.params, DT, DG_STEPS)
        torch.cuda.synchronize()
        n_launch = cloth_kernel.LAUNCHES_BATCHED
        p5 = cloth_kernel.multi_step_plain(state, wb.params, DT, DG_STEPS)
        e = max(_maxdiff(k5.pos, p5.pos), _maxdiff(k5.vel, p5.vel))
        bitwise = bool(torch.equal(k5.pos, p5.pos)
                       and torch.equal(k5.vel, p5.vel))
        ek1, k1_bitwise = 0.0, True
        for i in (0, 1, DG_WORLDS - 1):
            one = ClothState(
                pos=state.pos[i], vel=state.vel[i],
                pin_mask=None if state.pin_mask is None else state.pin_mask[i],
                pin_pos=None if state.pin_pos is None else state.pin_pos[i])
            k1 = cloth_kernel.multi_step_kernel(
                one, ClothParams(*(a[i] for a in wb.params)), DT, DG_STEPS)
            ek1 = max(ek1, _maxdiff(k5.pos[i], k1.pos),
                      _maxdiff(k5.vel[i], k1.vel))
            k1_bitwise &= bool(torch.equal(k5.pos[i], k1.pos)
                               and torch.equal(k5.vel[i], k1.vel))
        finite = bool(torch.isfinite(k5.pos).all()
                      and torch.isfinite(k5.vel).all())
        free = torch.ones_like(pin) if state.pin_mask is None else ~pin
        projected = float(((k5.vel == 0).all(1) & free).float().mean())
        print(f"phase 8 cloth_step_batched (K5) {label} {case} @{DG_WORLDS} x "
              f"60x60 x {DG_STEPS} substeps [{card}]: vs plain {e:.3e} "
              f"(<=1e-6), bitwise {bitwise}; vs K1 on worlds 0, 1, "
              f"{DG_WORLDS - 1} {ek1:.3e} (<=1e-6), bitwise {k1_bitwise}; "
              f"launches {n_launch}; finite {finite}; particles in contact "
              f"at the start {contact:.4f}, projected in the last substep "
              f"{projected:.4f}")
        _check(n_launch == DG_STEPS, f"K5 launched {n_launch} times")
        _check(e <= 1e-6, f"K5 {label} {case} vs plain diff {e}")
        _check(ek1 <= 1e-6, f"K5 {label} {case} vs K1 diff {ek1}")
        _check(finite, f"K5 {label} {case} state not finite")
        if need_contact:
            _check(contact > 0 and projected > 0,
                   f"K5 {label} {case}: no contact ({contact}, {projected})")
        if state.pin_mask is not None:
            _check(torch.equal(k5.pos[:, :, 0], state.pos[:, :, 0]),
                   "K5 pinned row moved")
        res[case] = {"err_vs_plain": e, "bitwise": bitwise,
                     "err_vs_k1": ek1, "bitwise_vs_k1": k1_bitwise,
                     "launches": n_launch, "contact_share": contact,
                     "projected_share": projected}
        err = max(err, e, ek1)
    return res, err


def _phase9_raster(settled, dev, card):
    """The batched raster at the datagen path's shape: one launch for a
    chunk of DG_CHUNK settled worlds at 256x256 against the plain sweep on
    its first, middle and last worlds (phase 4's contract). Returns the
    results, the largest error and the launch's inputs, which phase 6
    times."""
    import torch

    from wgpu_physics_engine_torch.ops import raster_kernel
    from wgpu_physics_engine_torch.parallel import datagen
    from wgpu_physics_engine_torch.render import camera as cam_mod

    n, (h, w) = DG_CHUNK, DG_FB
    cams = datagen.randomized_cameras(
        n, torch.Generator().manual_seed(DG_SEED + 2), device=dev)
    eye, dirs = cam_mod.pixel_rays(cams, h, w)
    centers = settled.state.pos[:n].reshape(n, 3, -1).transpose(1, 2)
    wins, ocb, _ = raster_kernel.tiled_prologue_batched(
        cams.view[:, :3, :3], eye, centers, settled.params.particle_radius[:n],
        cams.znear, torch.tan(cams.fovy_rad / 2.0), cams.aspect, h, w)
    raster_kernel.LAUNCHES = 0
    kt, ki, ko = raster_kernel.sphere_raster_kernel(wins, ocb, dirs,
                                                    cams.znear)
    torch.cuda.synchronize()
    _check(raster_kernel.LAUNCHES == 1,
           f"batched raster launched {raster_kernel.LAUNCHES} times")
    res, err = {}, 0.0
    for i in (0, n // 2 - 1, n - 1):
        pt, pi, po = raster_kernel.sphere_raster_plain(ocb[i], dirs[i],
                                                       cams.znear[i])
        hit_k, hit_p = ki[i] >= 0, pi >= 0
        agree = float((hit_k == hit_p).float().mean())
        both = hit_k & hit_p
        same = (ki[i] == pi) & hit_k
        n_hit, n_same = int(hit_k.sum()), int(same.sum())
        et = _maxdiff(kt[i][both], pt[both]) if bool(both.any()) else 0.0
        eo = _maxdiff(ko[i][:, same], po[:, same]) if n_same else 0.0
        miss = ~hit_k
        miss_ok = bool(torch.isinf(kt[i][miss]).all()
                       and (ko[i][:, miss] == 0).all())
        bitwise = bool(torch.equal(ki[i], pi) and torch.equal(kt[i], pt)
                       and torch.equal(ko[i], po))
        print(f"phase 9 batched sphere_raster world {i} of {n} @{h}x{w}: hit "
              f"agree {agree:.6f} (>=0.9999), hits {n_hit}, same winner "
              f"{n_same} (>=0.9999 of hits), tmin {et:.3e} oc {eo:.3e} "
              f"(<=1e-6), bitwise {bitwise}")
        _check(n_hit > 0, f"batched raster world {i}: no particle hit")
        _check(agree >= 0.9999, f"batched raster world {i} agreement {agree}")
        _check(n_same >= 0.9999 * n_hit,
               f"batched raster world {i}: winner agrees on {n_same} of "
               f"{n_hit}")
        _check(et <= 1e-6 and eo <= 1e-6,
               f"batched raster world {i} diff {et} {eo}")
        _check(miss_ok, f"batched raster world {i}: a miss is not (+inf, 0)")
        res[str(i)] = {"hit_agree": agree, "hits": n_hit,
                       "same_winner": n_same, "err_tmin": et, "err_oc": eo,
                       "bitwise": bitwise}
        err = max(err, et, eo)
    return res, err, (wins, ocb, dirs, cams.znear)


def _phase10_datagen(settled, dev, card, cli_main):
    """The datagen path, counted: 4096 worlds x 3 frames at 256x256 with the
    codec, then the CLI's datagen and decode; and the checks on it."""
    import numpy as np
    import torch

    from wgpu_physics_engine_torch.core.config import ClothConfig
    from wgpu_physics_engine_torch.ops import cloth_kernel, raster_kernel
    from wgpu_physics_engine_torch.parallel import codec, datagen
    from wgpu_physics_engine_torch.render import texture as tex_mod

    gen_kw = dict(n_worlds=DG_WORLDS, n_frames=3, steps_per_frame=DG_STEPS,
                  fb_size=DG_FB, randomize_cameras=True, world_chunk=DG_CHUNK,
                  device=dev)
    # the CLI's shards stay in the (ignored) build directory, not the
    # results brought back
    scratch = os.path.join(HERE, "build", "chip_smoke_datagen")
    dg_out, dg_dec = os.path.join(scratch, "enc"), os.path.join(scratch, "dec")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cloth_kernel.LAUNCHES = 0
    cloth_kernel.LAUNCHES_BATCHED = 0
    raster_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    frames, yields = [], []
    for f, enc, batches in datagen.generate_trajectory_dataset(
            ClothConfig(), generator=torch.Generator().manual_seed(DG_SEED + 1),
            codec_k=DG_K, worlds=settled, **gen_kw):
        frames.append(enc)
        yields.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    rc = cli_main(["datagen", "--worlds", "64", "--frames", "2", "--codec-k",
                   str(DG_K), "--outdir", dg_out, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = {"cloth_step": cloth_kernel.LAUNCHES,
                "cloth_step_batched": cloth_kernel.LAUNCHES_BATCHED,
                "sphere_raster": raster_kernel.LAUNCHES}
    rc_dec = cli_main(["decode", "--indir", dg_out, "--outdir", dg_dec])
    n_chunks = -(-DG_WORLDS // DG_CHUNK)
    print(f"phase 10 datagen path [{card}]: generate_trajectory_dataset("
          f"ClothConfig(), n_worlds={DG_WORLDS}, n_frames=3, steps_per_frame="
          f"{DG_STEPS}, fb_size={DG_FB}, randomize_cameras=True, codec_k="
          f"{DG_K}, world_chunk={DG_CHUNK}) {gen_s:.3f} s host clock (frames "
          f"yielded at {', '.join(f'{t:.3f}' for t in yields)} s), peak "
          f"device memory {peak / 2**30:.3f} GiB; CLI datagen rc {rc}, decode "
          f"rc {rc_dec}; launches {launches}")
    _check(rc == 0 and rc_dec == 0, f"CLI datagen/decode rc {rc} {rc_dec}")
    _check(launches["cloth_step_batched"] >= 3 * n_chunks * DG_STEPS
           and launches["sphere_raster"] >= 3 * n_chunks,
           f"a kernel of the datagen path never launched: {launches}")
    shape = (DG_WORLDS, DG_FB[0] // 8, DG_FB[1] // 8, 3, DG_K)
    _check(len(frames) == 3 and all(f.shape == shape and f.dtype == np.int8
                                    for f in frames),
           f"datagen frames {[(f.shape, f.dtype) for f in frames]}")
    _check(all(bool(torch.isfinite(b.state.pos).all()) for b in batches),
           "datagen state not finite")

    # frame 0 uncompressed, from the same worlds and cameras
    tex, chunks = _dg_setup(settled, DG_SEED + 1, dev)
    parts = _dg_frame(tex, chunks, None)
    raw = torch.cat(parts)
    red, globe = _classify(raw)
    share = float(((red > 0) & (globe > 0)).float().mean())
    # the yielded frame 0 is the device codec of exactly this frame
    enc_same = bool(np.array_equal(
        torch.cat([codec.encode(p, k=DG_K) for p in parts]).cpu().numpy(),
        frames[0]))
    sample = list(range(0, DG_WORLDS, 16))
    dec = codec.decode(frames[0][sample])     # NumPy: every 16th world
    raw_np = raw.cpu().numpy()
    psnrs = [codec.psnr(raw_np[i], dec[j]) for j, i in enumerate(sample)]
    mean_psnr = float(np.mean(psnrs))
    # the codec's quality floor on smooth content: the cached globes of the
    # same worlds, encoded on the card. (The cloth's 1.5-pixel particles are
    # detail that 16 of 64 coefficients cannot carry: the frames' PSNR at
    # k = 16 is a property of the codec, reported, not checked.)
    globes = torch.cat([(torch.clamp(fb.color, 0.0, 1.0) * 255.0 + 0.5)
                        .to(torch.uint8) for fb in chunks[2]])[sample]
    g_dec = codec.decode(codec.encode(globes, k=DG_K).cpu().numpy())
    globes = globes.cpu().numpy()
    g_psnr = float(np.mean([codec.psnr(globes[j], g_dec[j])
                            for j in range(len(sample))]))
    print(f"phase 10 frames: worlds with particle and globe pixels "
          f"{share:.4f} (>=0.9); particle px a world mean "
          f"{float(red.float().mean()):.1f}; yielded frame 0 == encode(raw "
          f"frame 0) {enc_same}; decode(frame 0) PSNR vs the raw frame over "
          f"{len(sample)} worlds mean {mean_psnr:.3f} dB, min "
          f"{min(psnrs):.3f} (the codec at k = {DG_K}, reported); the cached "
          f"globes alone {g_psnr:.3f} dB (>=28)")
    _check(share >= 0.9, f"only {share} of worlds show cloth and globe")
    _check(enc_same, "yielded frame 0 is not the codec of the raw frame 0")
    _check(g_psnr >= 28.0, f"codec PSNR on the globes {g_psnr}")

    # 16 of the worlds, 3 frames, uncompressed, three ways: the kernel
    # path; the same code with the kernels' plain versions (K5 and the
    # raster each equal theirs bit for bit, so the frames must be equal);
    # and use_kernel=False, the stencil twin. The twin adds the spring
    # forces in another order, and on the draped cloth the contact test
    # (dist < min_dist, right after the projection set dist = min_dist)
    # turns on rounding, so the two states part by more than rounding and
    # a particle's silhouette may cross a pixel centre: such a pixel flips
    # whole (|d| up to 255), hence a share of pixels, not every pixel.
    few = datagen.WorldBatch(
        state=settled.state._replace(pos=settled.state.pos[:16],
                                     vel=settled.state.vel[:16]),
        params=type(settled.params)(*(a[:16] for a in settled.params)))
    runs, ends = {}, {}
    for way in ("kernel", "plain", "twin"):
        with _plain_wrappers() if way == "plain" else contextlib.nullcontext():
            runs[way] = []
            for _, im, bs in datagen.generate_trajectory_dataset(
                    ClothConfig(), generator=torch.Generator().manual_seed(
                        DG_SEED + 3), worlds=few, use_kernel=way != "twin",
                    **{**gen_kw, "n_worlds": 16, "world_chunk": None}):
                runs[way].append(im)
            ends[way] = bs[0].state.pos
    exact = (all(np.array_equal(a, b)
                 for a, b in zip(runs["kernel"], runs["plain"], strict=True))
             and bool(torch.equal(ends["kernel"], ends["plain"])))
    d = np.concatenate([np.abs(a.astype(np.int16) - b.astype(np.int16)).max(-1)
                        for a, b in zip(runs["kernel"], runs["twin"])])
    within = float((d <= 1).mean())
    e_pos = _maxdiff(ends["kernel"], ends["twin"])
    print(f"phase 10 on 16 worlds x 3 frames: kernel path == the same path "
          f"with the plain stepper and sweep {exact} (frames and end state); "
          f"vs use_kernel=False uint8 |d| <= 1 on {within:.6f} of pixels "
          f"(>=0.999), {int((d > 1).sum())} pixels over (a silhouette "
          f"crossing a pixel centre), max {int(d.max())}; end states apart "
          f"by {e_pos:.3e}")
    _check(exact, "kernel datagen frames differ from the plain versions'")
    _check(within >= 0.999, f"kernel vs stencil twin datagen frames: {within}")
    return {"launches": launches, "generate_s": gen_s, "yields_s": yields,
            "peak_bytes": peak, "cli_rc": [rc, rc_dec],
            "cloth_and_globe_share": share, "psnr_mean": mean_psnr,
            "psnr_min": min(psnrs), "psnr_globes": g_psnr,
            "encode_equal": enc_same, "kernel_equals_plain": exact,
            "kernel_vs_twin_within_1": within,
            "kernel_vs_twin_end_pos": e_pos,
            "kernel_vs_twin_over_1": int((d > 1).sum())}


def _dg_times(settled, raster_in, dev, card) -> dict:
    """Phase 6 for the datagen path: K5 per call beside its plain version
    and bound, phase 9's raster launch on 1024 worlds, one steady frame of
    all worlds with and without the codec, and the copy into pinned
    memory."""
    import torch

    from wgpu_physics_engine_torch.ops import cloth_kernel, raster_kernel

    res = {}
    k_ms = _best_ms(lambda: cloth_kernel.multi_step_kernel(
        settled.state, settled.params, DT, DG_STEPS))
    p_ms = _best_ms(lambda: cloth_kernel.multi_step_plain(
        settled.state, settled.params, DT, DG_STEPS))
    b_ms, b_by = _cloth_bound(60, 60, DG_WORLDS, DG_STEPS)
    res["k5"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                 "bound_by": b_by}
    print(f"phase 6 cloth_step_batched (K5) {DG_WORLDS} x 60x60 x {DG_STEPS} "
          f"substeps [{card}]: kernel {k_ms:.4f} ms/call, plain {p_ms:.4f} "
          f"ms/call, bound {b_ms:.4f} ms ({b_by}), kernel at "
          f"{b_ms / k_ms:.4f} of the bound")

    wins, ocb, dirs, znear = raster_in
    n, (h, w) = dirs.shape[0], DG_FB
    r_ms = _best_ms(lambda: raster_kernel.sphere_raster_kernel(
        wins, ocb, dirs, znear))
    rb_ms, rb_by = _raster_bound(wins, ocb.shape[-1], h, w)
    res["raster_1024"] = {"ms": r_ms, "bound_ms": rb_ms, "bound_by": rb_by,
                          "worlds": n}
    print(f"phase 6 batched sphere_raster {n} worlds @{h}x{w} [{card}]: "
          f"{r_ms:.4f} ms/launch, bound {rb_ms:.4f} ms ({rb_by})")

    tex, chunks = _dg_setup(settled, DG_SEED + 4, dev)
    out = {}
    for codec_k in (None, DG_K):
        ms = _best_ms(lambda: _dg_frame(tex, chunks, codec_k))
        parts = _dg_frame(tex, chunks, codec_k)
        host = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                for p in parts]

        def copy():
            for hb, p in zip(host, parts):
                hb.copy_(p, non_blocking=True)

        c_ms = _best_ms(copy)
        nbytes = sum(p.numel() * p.element_size() for p in parts)
        key = "raw" if codec_k is None else f"codec_k{codec_k}"
        out[key] = {"frame_ms": ms, "ms_per_world": ms / DG_WORLDS,
                    "egress_bytes": nbytes, "egress_ms": c_ms,
                    "egress_MBps": nbytes / 1e6 / (c_ms / 1e3)}
        print(f"phase 6 datagen steady frame {key} [{card}]: {ms:.3f} ms for "
              f"{DG_WORLDS} worlds = {ms / DG_WORLDS:.5f} ms/world (CUDA "
              f"events, step + render{'' if codec_k is None else ' + codec'}); "
              f"egress {nbytes / 1e6:.1f} MB into pinned memory in "
              f"{c_ms:.3f} ms = {nbytes / 1e6 / (c_ms / 1e3):.1f} MB/s")
    res["frame"] = out
    res["chunks"] = chunks
    res["tex"] = tex
    return res


def _dg_trace(tex, chunks, card) -> dict:
    """Phase 7 for the datagen path: one torch.profiler trace of one steady
    frame of all worlds with the codec and the copy to pinned memory, split
    into K5, raster, composite (the rest of the render range: binning,
    rays, shading of the hits, the uint8 cast), codec and copy, with the
    device's idle share over the frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wgpu_physics_engine_torch.parallel import datagen

    side = torch.cuda.Stream()
    path = os.path.join(OUT, "trace_datagen_frame.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        parts = _dg_frame(tex, chunks, DG_K)
        datagen._Fetch(parts, side).wait()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation"
              and e["name"].startswith("datagen.")]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    split = {"k5": 0.0, "raster": 0.0, "composite": 0.0, "codec": 0.0,
             "copy": 0.0, "other": 0.0}
    for e in dev:
        name = e["name"]
        t = launch.get(e.get("args", {}).get("correlation"))
        owner = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
        owner = min(owner, key=lambda r: r[1] - r[0])[2] if owner else ""
        if "substep_kernel_batched" in name:
            split["k5"] += e["dur"]
        elif "sphere_raster" in name:
            split["raster"] += e["dur"]
        elif e.get("cat") == "gpu_memcpy" or owner == "datagen.fetch":
            split["copy"] += e["dur"]
        elif owner == "datagen.codec":
            split["codec"] += e["dur"]
        elif owner == "datagen.render":
            split["composite"] += e["dur"]
        else:
            split["other"] += e["dur"]
    host = [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation")]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in dev]
    _check(bool(spans) and bool(host), "datagen trace: no device/host spans")
    t0 = min(a for a, _ in host + spans)
    t1 = max(b for _, b in host + spans)
    busy = _union_us(spans)
    idle = 1.0 - busy / (t1 - t0)
    _check(split["k5"] > 0 and split["raster"] > 0,
           f"datagen trace shows no K5 or raster time: {split}")
    print(f"phase 7 trace one datagen frame, {DG_WORLDS} worlds with codec "
          f"and copy [{card}]: window {t1 - t0:.1f} us (host, profiled), "
          f"device busy {busy:.1f} us in {len(dev)} device ops; device time "
          f"us: " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
          + f"; device idle share {idle:.4f}")
    return {"window_us": t1 - t0, "device_busy_us": busy,
            "device_ops": len(dev), "split_us": split, "idle_share": idle}


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
    from wgpu_physics_engine_torch.parallel import datagen
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
    k1_bound, k1_by = _cloth_bound(GRID, GRID, 1, n)
    r_bound, r_by = _raster_bound(wins, ocb.shape[-1], fh, fw)

    # ---- phase 8: K5 on the card, on fresh and on settled worlds ----
    fresh = datagen.randomized_worlds(
        ClothConfig(), DG_WORLDS, torch.Generator().manual_seed(DG_SEED),
        device=dev)
    k5_res, k5_err = {}, 0.0
    k5_res["fresh"], e = _phase8_k5(fresh, "fresh", dev, card, False)
    k5_err = max(k5_err, e)
    # drop the fresh worlds onto the globe (3 s), where the contact and
    # friction branches run and the randomized views of phases 9 and 10
    # see the cloth
    settled = datagen.WorldBatch(
        state=cloth_kernel.multi_step_kernel(fresh.state, fresh.params, DT,
                                             DG_SETTLE),
        params=fresh.params)
    del fresh
    k5_res["settled"], e = _phase8_k5(settled, "settled", dev, card, True)
    k5_err = max(k5_err, e)
    results["cloth_step_batched"] = k5_res

    # ---- phase 9: the batched raster, one chunk of worlds ----
    results["sphere_raster_batched"], r9_err, raster_in = _phase9_raster(
        settled, dev, card)

    # ---- phase 10: the datagen path, counted ----
    results["datagen"] = _phase10_datagen(settled, dev, card, cli_main)
    dg_launches = results["datagen"]["launches"]

    # ---- phases 6 and 7 for the datagen path ----
    dg = _dg_times(settled, raster_in, dev, card)
    del raster_in
    chunks, tex = dg.pop("chunks"), dg.pop("tex")
    dg["trace"] = _dg_trace(tex, chunks, card)
    results["datagen_times"] = dg
    with open(os.path.join(OUT, "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)

    kernels = [
        {"name": "cloth_step", "route": "cuda",
         "source": "wgpu_physics_engine_torch/ops/csrc/cloth_step.cu",
         "replaces": "wgpu_physics_engine_tpu/ops/cloth_pallas.py:195",
         "launches": launches["cloth_step"],
         "max_abs_err": max(e1, e240, efp), "ms": k_ms / n,
         "plain_ms": p_ms / n, "bound_ms": k1_bound / n, "bound_by": k1_by,
         "library_ms": None},
        {"name": "cloth_step_batched", "route": "cuda",
         "source": "wgpu_physics_engine_torch/ops/csrc/cloth_step.cu",
         "replaces": "wgpu_physics_engine_tpu/ops/cloth_pallas.py:345",
         "launches": dg_launches["cloth_step_batched"],
         "max_abs_err": k5_err, "ms": dg["k5"]["ms"],
         "plain_ms": dg["k5"]["plain_ms"], "bound_ms": dg["k5"]["bound_ms"],
         "bound_by": dg["k5"]["bound_by"], "library_ms": None},
        {"name": "sphere_raster", "route": "cuda",
         "source": "wgpu_physics_engine_torch/ops/csrc/sphere_raster.cu",
         "replaces": "wgpu_physics_engine_tpu/ops/raster_pallas.py:209",
         "launches": launches["sphere_raster"] + dg_launches["sphere_raster"],
         "max_abs_err": max(r_err, r9_err), "ms": rk_ms, "plain_ms": rp_ms,
         "bound_ms": r_bound, "bound_by": r_by, "library_ms": None},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
