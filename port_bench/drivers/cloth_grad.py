"""Driver of the gradient cells: the program's differentiable cloth
(``examples/differentiable_cloth.py`` ``rollout`` with ``use_kernel``:
``models.cloth.multi_step_diff`` in segments, the cloth kernel forward and
the hand-written adjoint backward) from the draped sheet of the single-cloth
driver's set-up.

A unit is one iteration of the example's fit: the loss ``(mean height
after unit_seconds - TARGET_Y)²`` and its gradient by
``torch.autograd.grad`` in each of the mix's ``leaves`` (gravity, and
further ``ClothParams`` leaves made to require a gradient), ending when
all are on the host. Each unit's gravity is drawn from the seed (the
configuration's gravity times 1 + U(±grav_jitter)), so the units differ
and none depends on another.

The check: the drape (as the single-cloth driver checks it), and
``sample_units`` window units drawn from the seed among the first
``sample_window``. The reference runs the same substeps from the draped
state and takes the gradient of its packed parameters by torch's reverse
mode through its own plain substep (nothing of the program's adjoint), and
is compared by ``loss_rel_gap`` and ``grad_rel_gap.<leaf>``: |program -
reference| over |reference|.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..harness import worst
from ..reference import cloth as ref_cloth
from . import scene_sim


def rel_gap(got: float, ref: float) -> float:
    """|got - ref| / |ref|; a reference of 0 gives 0 where ``got`` is 0
    too, and inf where it is not."""
    if ref == 0.0:
        return 0.0 if got == 0.0 else math.inf
    return abs(got - ref) / abs(ref)


class Cell(scene_sim.Cell):
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        g0 = config["cloth"]["gravity"]
        j = traffic["grav_jitter"]
        self.gravity = (g0 * (1.0 + j * (2.0 * np.random.default_rng(
            seed).random(1 << 16) - 1.0))).astype(np.float32)
        self.next_unit = 0
        self.leaves = traffic["leaves"]
        self._refs = {}
        assert self.leaves[0] == "gravity", self.leaves

    def warm_up(self):
        """The drape (checked from the seeded sheet) and one unit."""
        from wgpu_physics_engine_torch.examples import differentiable_cloth

        self.example = differentiable_cloth
        self.scene.simulate(self.cfg["drape_seconds"])
        self.records.append({"pos": self.start[0], "vel": self.start[1],
                             "steps": self.drape_steps, "start": True,
                             "out": self.scene.state.pos.clone()})
        self.state0 = self.scene.state
        self.base = self.scene.params
        self.dt = torch.tensor(1.0 / self.hz, dtype=torch.float32,
                               device=self.device)
        it = self.units()
        next(it)
        it.close()

    def units(self, traced: bool = False):
        f = 0
        ex = self.example
        while True:
            g_k = float(self.gravity[self.next_unit % len(self.gravity)])
            self.next_unit += 1
            t_issue = time.perf_counter()
            g = torch.tensor(g_k, dtype=torch.float32, device=self.device,
                             requires_grad=True)
            others = {k: getattr(self.base, k).detach().clone()
                      .requires_grad_(True) for k in self.leaves[1:]}
            base = self.base._replace(**others)
            y = ex.rollout(self.state0, base, g, self.dt, True,
                           self.unit_steps, self.traffic["segment"])
            loss = (y - ex.TARGET_Y) ** 2
            grads = torch.autograd.grad(loss, [g, *others.values()])
            host = torch.stack([loss.detach(), *grads]).cpu()
            t_done = time.perf_counter()
            if f in self.sampled:
                self.samples[f] = {"gravity": g_k, "out": host}
            yield t_issue, t_done
            f += 1

    def free(self):
        self.records += [r for r in self.samples.values() if "out" in r]
        self.drape = self.state0.pos.clone(), self.state0.vel.clone()
        del self.scene, self.state0, self.base
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def reference(self, g_k: float, dtype=torch.float32):
        """``(loss, {leaf: d loss / d leaf})`` of the reference from the
        draped state under gravity ``g_k``: its own reverse mode, through
        the packed parameters, a segment of substeps recomputed at a time
        (computed once a gravity and dtype)."""
        key = (g_k, dtype)
        if key in self._refs:
            return self._refs[key]
        c = self.cfg["cloth"]
        pos, vel = self.drape
        g = torch.tensor(g_k, dtype=torch.float32, device=self.device)
        prm = ref_cloth.pack(c, 1.0 / self.hz, self.device,
                             gravity=g).requires_grad_(True)

        def segment(p, v, prm, n):
            return ref_cloth.multi_step(p, v, prm, n, dtype=dtype)

        p, v = pos, vel
        seg = self.traffic["segment"]
        for s0 in range(0, self.unit_steps, seg):
            p, v = checkpoint(segment, p, v, prm,
                              min(seg, self.unit_steps - s0),
                              use_reentrant=False)
        loss = (p[1].mean() - self.example.TARGET_Y) ** 2
        (d_prm,) = torch.autograd.grad(loss, prm)
        col = ref_cloth.PARAM_NAMES.index
        out = float(loss.detach()), {k: float(d_prm[col(k)])
                                     for k in self.leaves}
        self._refs[key] = out
        return out

    def check(self, control=None) -> Dict[str, float]:
        """``start_gap_m`` of the drape (see the single-cloth driver) and the
        widest ``loss_rel_gap`` and ``grad_rel_gap.<leaf>`` over the
        checked units. With ``control`` (a dtype: bfloat16 for the
        control) the reference computed in it is judged in the program's
        place."""
        out = super().check(control, [r for r in self.records
                                      if "steps" in r])
        units = [r for r in self.records if "gravity" in r]
        gaps = dict.fromkeys(["loss_rel_gap"] + ["grad_rel_gap." + k
                                                 for k in self.leaves],
                             0.0 if units else math.inf)
        for rec in units:
            loss, grads = self.reference(rec["gravity"])
            if control is not None:
                got_loss, got = self.reference(rec["gravity"], control)
            else:
                got_loss = float(rec["out"][0])
                got = {k: float(rec["out"][1 + i])
                       for i, k in enumerate(self.leaves)}
            gaps["loss_rel_gap"] = worst(gaps["loss_rel_gap"],
                                         rel_gap(got_loss, loss))
            for k in self.leaves:
                key = "grad_rel_gap." + k
                gaps[key] = worst(gaps[key], rel_gap(got[k], grads[k]))
        out.update(gaps)
        return out
