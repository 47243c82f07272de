"""Driver of the batched datagen cells: thousands of cloth worlds stepped,
rendered and encoded a frame at a time through the program's datagen
path (``parallel/datagen.py``: ``world_chunks``, ``frame_parts`` or
``encode_parts``, ``stream_frames``).

A unit is one frame of every world, from its issue to its bytes in pinned
host memory: with ``codec`` the int8 DCT coefficients of the rendered
frames, without it the cloth positions (no render). ``stream_frames``
issues frame f+1 before it waits for frame f, as the generator does.

The inputs are drawn on the device from the seed, in bulk, with the
distributions of the program's ``randomized_worlds`` and
``randomized_cameras``: a height offset U(±height_jitter) a world,
velocities N(0, vel_jitter²) a particle and axis, a stiffness scale 1 +
U(±stiffness_jitter) a world, and an orbit camera a world. Both the
program and the reference get them.

Set-up drops the fresh worlds onto the globe (``settle_seconds``) with the
program's stepper, as the views aim at the globe.

The check: the drop, the frame that set-up renders first, and
``sample_frames`` window frames drawn from the seed among the first
``sample_window``, each on ``sample_worlds`` worlds drawn from the seed.
Before a sampled frame the sampled worlds' state is copied aside; the
reference steps it ``steps_per_frame`` substeps (and renders and encodes
it) and is compared with what the program produced: the positions its
state holds after the frame, and the bytes that reached the host.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from ..harness import ROOT, worst
from ..reference import cloth as ref_cloth
from ..reference import codec as ref_codec
from ..reference import render as ref_render


def _cloth_config(c: Dict):
    from wgpu_physics_engine_torch.core.config import ClothConfig

    n = c["particles_per_side"]
    return ClothConfig(
        height=n, width=n, cloth_size=c["cloth_size"],
        center=tuple(c["center"]), particle_radius=c["particle_radius"],
        globe_radius=c["globe_radius"], mass=c["mass"], gravity=c["gravity"],
        speed_damp=c["speed_damp"], k_contact=c["k_contact"], mu=c["mu"],
        k_struct=c["k_struct"], k_shear=c["k_shear"], k_bend=c["k_bend"],
        c_struct=c["c_struct"], c_shear=c["c_shear"], c_bend=c["c_bend"],
        hz=c["hz"])


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from wgpu_physics_engine_torch import render as R
        from wgpu_physics_engine_torch.core.config import CameraConfig
        from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                          ClothState)
        from wgpu_physics_engine_torch.parallel import datagen

        self.cfg, self.traffic, self.device = config, traffic, device
        self.datagen = datagen
        c = config["cloth"]
        n, nw = c["particles_per_side"], config["worlds"]
        self.n, self.nw = n, nw
        self.unit_work = nw                  # world-frames a unit
        self.steps = config["steps_per_frame"]
        self.dt = 1.0 / c["hz"]
        self.codec_k = traffic.get("codec_k")
        rz, cam = config["randomize"], config["camera"]

        # the inputs, in a few large draws on the device
        gen = torch.Generator(device=device).manual_seed(seed)
        u = torch.rand((5, nw), generator=gen, device=device)
        vel = rz["vel_jitter"] * torch.randn((nw, 3, n, n), generator=gen,
                                             device=device)
        dy = -rz["height_jitter"] + 2.0 * rz["height_jitter"] * u[0]
        pos = ref_cloth.init_grid(c, device).expand(nw, 3, n, n).clone()
        pos[:, 1] += dy[:, None, None]
        self.scale = 1.0 + rz["stiffness_jitter"] * (-1.0 + 2.0 * u[1])
        lo, hi = rz["camera_radius"]
        self.radius = (lo + (hi - lo) * u[2]).cpu()
        self.theta = (2.0 * math.pi * u[3]).cpu()
        lo, hi = rz["camera_phi"]
        self.phi = (lo + (hi - lo) * u[4]).cpu()

        ccfg = _cloth_config(c)
        p1 = ClothParams.from_config(ccfg, device=device)
        params = ClothParams(*(leaf.expand(nw).contiguous() for leaf in p1))
        params = params._replace(k_struct=p1.k_struct * self.scale,
                                 k_shear=p1.k_shear * self.scale,
                                 k_bend=p1.k_bend * self.scale)
        cams = R.make_camera(
            CameraConfig(fovy_deg=cam["fovy_deg"], znear=cam["znear"],
                         zfar=cam["zfar"], target=tuple(cam["target"])),
            1.0, radius=self.radius, theta=self.theta, phi=self.phi,
            device=device)
        self.tex = datagen.globe_texture(device)
        self.fb = tuple(config["frame"])
        self.batches, self.cameras, self.base_fbs = datagen.world_chunks(
            ccfg, nw, self.tex, None, self.fb, camera=cams,
            world_chunk=config["world_chunk"], randomize_cameras=False,
            cache_globe=self.codec_k is not None,
            worlds=datagen.WorldBatch(ClothState(pos=pos, vel=vel), params),
            device=device)
        self.chunk = config["world_chunk"]
        self.gen_host = np.random.default_rng(seed)
        self.samples = {}          # frame index → sampled record
        self.sampled = {}          # frame index → world ids
        self.records: List[Dict] = []
        self.traced_pos: List[torch.Tensor] = []
        self._settle(int(round(config["settle_seconds"] * c["hz"])))

    def _settle(self, n_steps: int):
        """Drop the fresh worlds onto the globe with the program's stepper,
        so that the frames of the window see draped cloth (the views aim at
        the globe); the sampled worlds' drop is checked."""
        from wgpu_physics_engine_torch.ops import cloth_kernel

        ids = self._draw_worlds()
        pos, vel = self._state_of(ids)
        for i, b in enumerate(self.batches):
            self.batches[i] = b._replace(state=cloth_kernel.multi_step(
                b.state, b.params, self.dt, n_steps))
        self.records.append({"ids": ids, "pos": pos, "vel": vel,
                             "steps": n_steps,
                             "pos_after": self._state_of(ids)[0]})

    # -- the program's frame ------------------------------------------------
    def _frame(self):
        if self.codec_k is not None:
            return self.datagen.frame_parts(
                self.batches, self.cameras, self.base_fbs, self.dt,
                self.steps, self.tex, self.fb, codec_k=self.codec_k)
        from wgpu_physics_engine_torch.ops import cloth_kernel

        def step(bi, b):
            with record_function("datagen.step"):
                s = cloth_kernel.multi_step(b.state, b.params, self.dt,
                                            self.steps)
            return b._replace(state=s), s.pos
        return self.datagen.encode_parts(self.batches, step)

    def _state_of(self, ids):
        """The sampled worlds' state, copied aside: ``(pos, vel)``."""
        pos = torch.stack([self.batches[i // self.chunk].state.pos[
            i % self.chunk] for i in ids])
        vel = torch.stack([self.batches[i // self.chunk].state.vel[
            i % self.chunk] for i in ids])
        return pos, vel

    def units(self, traced: bool = False):
        """Closed loop over frames: yields ``(t_issue, t_done)`` per frame
        whose bytes have landed on the host."""
        issue = []
        f_call = [0]
        pending_post = {}

        def frame():
            f = f_call[0]
            f_call[0] += 1
            issue.append(time.perf_counter())
            if f - 1 in pending_post:       # the state after frame f - 1
                rec = pending_post.pop(f - 1)
                rec["pos_after"] = self._state_of(rec["ids"])[0]
            if f in self.sampled:
                ids = self.sampled[f]
                pos, vel = self._state_of(ids)
                rec = {"ids": ids, "pos": pos, "vel": vel,
                       "steps": self.steps}
                self.samples[f] = rec
                pending_post[f] = rec
            parts = self._frame()
            if traced and self.codec_k is not None:
                # the frame's positions, for the raster's work count
                with record_function("bench.work"):
                    torch.cat([b.state.pos for b in self.batches],
                              out=ring[f % len(ring)])
                self.traced_pos = ring[f % len(ring) + 1:] + \
                    ring[:f % len(ring) + 1]
            return parts

        ring = []
        if traced and self.codec_k is not None:
            ring = [torch.empty((self.nw, 3, self.n, self.n),
                                device=self.device)
                    for _ in range(self.traffic["trace_units"] + 2)]
        gen = self.datagen.stream_frames(frame, 1 << 30, self.batches,
                                         self.device)
        try:
            for f, host, _ in gen:
                t_done = time.perf_counter()
                if f in self.samples:
                    self.samples[f]["out"] = torch.from_numpy(
                        host[self.samples[f]["ids"]].copy())
                yield issue[f], t_done
        finally:
            gen.close()

    # -- set-up ----------------------------------------------------------------
    def warm_up(self):
        """Two frames after the drop; the first is checked."""
        ids = self._draw_worlds()
        self.sampled = {0: ids}
        it = self.units()
        for _ in range(2):
            next(it)
        it.close()
        self.records.append(self.samples.pop(0))
        self.sampled = {}

    def _draw_worlds(self):
        return sorted(self.gen_host.choice(
            self.nw, self.traffic["sample_worlds"], replace=False).tolist())

    def plan(self, rng):
        frames = rng.sample(range(self.traffic["sample_window"]),
                            self.traffic["sample_frames"])
        self.sampled = {f: self._draw_worlds() for f in frames}
        self.samples = {}

    def free(self):
        self.records += [r for r in self.samples.values() if "out" in r]
        del self.batches, self.cameras, self.base_fbs
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def work(self) -> Dict:
        return {"grid": (self.n, self.n), "worlds": self.nw,
                "chunk": self.chunk, "steps": self.steps,
                "frame": self.fb, "theta": self.theta, "phi": self.phi,
                "radius": self.radius, "positions": self.traced_pos}

    # -- the check ---------------------------------------------------------------
    def reference(self, rec, dtype=torch.float32):
        """The reference's positions after the record's substeps and, for a
        frame with the codec, its coefficients."""
        c = self.cfg["cloth"]
        ids = torch.tensor(rec["ids"])
        prm = ref_cloth.pack(c, self.dt, self.device,
                             stiffness_scale=self.scale[ids.to(
                                 self.scale.device)])
        pos, _ = ref_cloth.multi_step(
            rec["pos"], rec["vel"], prm, rec["steps"], dtype=dtype,
            graph_steps=48 if rec["steps"] >= 96 else None)
        if self.codec_k is None or "out" not in rec:
            return pos, None
        tex = ref_render.load_texture(
            os.path.join(ROOT, self.cfg["globe_texture"]),
            self.cfg["texture_max_size"], self.device)
        img = ref_render.frame(pos, self.theta[ids], self.phi[ids],
                               self.radius[ids], self.cfg, tex, dtype)
        return pos, ref_codec.encode(img, self.codec_k,
                                     self.cfg["codec_quality"], dtype)

    def check(self, control=None) -> Dict[str, float]:
        """The widest gaps: ``start_gap_m``, the largest |program -
        reference| of a position after the drop onto the globe;
        ``pos_mean_gap_m``, the widest mean |program - reference| of the
        positions after a sampled frame (a mean, since a few particles at a
        friction or contact threshold part ways on rounding alone); with the
        codec ``coef_mean_gap``, the widest mean |program - reference| of a
        frame's int8 coefficients. With ``control`` (a dtype: bfloat16 for
        the control) the reference computed in it is judged in the
        program's place."""
        out = {"start_gap_m": 0.0, "pos_mean_gap_m": 0.0}
        if self.codec_k is not None:
            out["coef_mean_gap"] = 0.0
        for rec in self.records:
            pos, coef = self.reference(rec)
            if control is not None:
                got_pos, got_coef = self.reference(rec, control)
            else:
                host = "out" in rec and self.codec_k is None
                got_pos = rec["out"] if host else rec["pos_after"]
                got_coef = rec.get("out")
            gap = (got_pos.to(pos.device) - pos).abs()
            if "out" in rec:
                out["pos_mean_gap_m"] = worst(out["pos_mean_gap_m"],
                                              float(gap.mean()))
            else:
                out["start_gap_m"] = worst(out["start_gap_m"],
                                           float(gap.max()))
            if coef is not None:
                out["coef_mean_gap"] = worst(out["coef_mean_gap"], float(
                    (got_coef.to(coef.device).double() - coef.double())
                    .abs().mean()))
        return out
