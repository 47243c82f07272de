"""Driver of the single-cloth cells: one cloth of the configuration's grid
over the globe, stepped headless through the program's scene
(``models/scenes.py`` ``ClothScene.simulate``).

Set-up seeds the sheet (a height offset U(±height_jitter) and velocities
N(0, vel_jitter²) a particle and axis, drawn on the device) and drapes it
with ``ClothScene.simulate(drape_seconds)``, so contact and friction are
active in the window. A unit is ``simulate(unit_seconds)`` and the
positions copied to pinned host memory.

The check: the drape, from the seeded sheet, and ``sample_units`` window
units drawn from the seed among the first ``sample_window``. Before a
sampled unit the scene's state is copied aside; the reference steps it as
many substeps and is compared with the positions that reached the host.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from ..harness import worst
from ..reference import cloth as ref_cloth
from .datagen import _cloth_config


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from wgpu_physics_engine_torch.core.state import ClothState
        from wgpu_physics_engine_torch.models.scenes import ClothScene

        self.cfg, self.traffic, self.device = config, traffic, device
        c = config["cloth"]
        n = c["particles_per_side"]
        self.n = n
        self.hz = c["hz"]
        rz = config["randomize"]
        gen = torch.Generator(device=device).manual_seed(seed)
        u = torch.rand((1,), generator=gen, device=device)
        vel = rz["vel_jitter"] * torch.randn((3, n, n), generator=gen,
                                             device=device)
        pos = ref_cloth.init_grid(c, device)
        pos[1] += -rz["height_jitter"] + 2.0 * rz["height_jitter"] * u[0]
        self.scene = ClothScene(config=_cloth_config(c), device=device)
        self.scene.state = ClothState(pos=pos, vel=vel)
        self.start = (pos.clone(), vel.clone())
        self.unit_steps = int(round(traffic["unit_seconds"] * self.hz))
        self.drape_steps = int(round(config["drape_seconds"] * self.hz))
        self.unit_work = n * n * self.unit_steps    # particle-steps a unit
        self.sampled = set()
        self.samples = {}
        self.records = []

    def warm_up(self):
        """The drape (checked from the seeded sheet), then one unit."""
        self.scene.simulate(self.cfg["drape_seconds"])
        self.records.append({"pos": self.start[0], "vel": self.start[1],
                             "steps": self.drape_steps, "start": True,
                             "out": self.scene.state.pos.clone()})
        it = self.units()
        next(it)
        it.close()

    def units(self, traced: bool = False):
        f = 0
        while True:
            t_issue = time.perf_counter()
            if f in self.sampled:
                s = self.scene.state
                self.samples[f] = {"pos": s.pos.clone(), "vel": s.vel.clone(),
                                   "steps": self.unit_steps}
            self.scene.simulate(self.traffic["unit_seconds"])
            pos = self.scene.state.pos
            host = torch.empty(pos.shape, dtype=pos.dtype,
                               pin_memory=self.device != "cpu")
            host.copy_(pos, non_blocking=True)
            if self.device != "cpu":
                torch.cuda.current_stream().synchronize()
            t_done = time.perf_counter()
            if f in self.samples:
                self.samples[f]["out"] = host
            yield t_issue, t_done
            f += 1

    def plan(self, rng):
        self.sampled = set(rng.sample(range(self.traffic["sample_window"]),
                                      self.traffic["sample_units"]))
        self.samples = {}

    def free(self):
        self.records += [r for r in self.samples.values() if "out" in r]
        del self.scene
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def work(self) -> Dict:
        return {"grid": (self.n, self.n), "steps": self.unit_steps}

    def check(self, control=None, records=None) -> Dict[str, float]:
        """``start_gap_m``, the largest |program - reference| of a position
        after the drape, and ``pos_mean_gap_m``, the widest mean |program -
        reference| of the positions after a sampled unit (a mean, since a
        few particles at a friction or contact threshold part ways on
        rounding alone), over ``records`` (default all). With ``control``
        (a dtype: bfloat16 for the control) the reference computed in it
        is judged in the program's place."""
        prm = ref_cloth.pack(self.cfg["cloth"], 1.0 / self.hz, self.device)
        out = {}
        for rec in self.records if records is None else records:
            ref, _ = ref_cloth.multi_step(rec["pos"], rec["vel"], prm,
                                          rec["steps"], graph_steps=48)
            if control is not None:
                got, _ = ref_cloth.multi_step(rec["pos"], rec["vel"], prm,
                                              rec["steps"], control,
                                              graph_steps=48)
            else:
                got = rec["out"].to(ref.device)
            gap = (got - ref).abs()
            if rec.get("start"):
                out["start_gap_m"] = worst(out.get("start_gap_m", 0.0),
                                           float(gap.max()))
            else:
                out["pos_mean_gap_m"] = worst(out.get("pos_mean_gap_m", 0.0),
                                              float(gap.mean()))
        return out
