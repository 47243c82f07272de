"""Differentiable simulation: the port of ``examples/differentiable_cloth.py``.

Recovers the gravity that brings the cloth's centre of mass to a target
height after one simulated second, by gradient descent through 480
physics substeps (springs, damping, contact, friction, projection).

    python -m wgpu_physics_engine_torch.examples.differentiable_cloth \\
        [--kernel] [--grid N] [--device cuda|cpu]

``--kernel`` routes the rollout through ``models.cloth.multi_step_diff``
in segments of 48 substeps: on a CUDA device the forward runs the fused
cloth kernel and the backward the hand-written substep adjoint
(``ops/csrc/cloth_grad.cu``); on the CPU their plain versions. Without
it, autograd differentiates through ``models.cloth.substep`` with
``torch.utils.checkpoint`` around every substep, as the JAX example uses
``jax.checkpoint``. ``--grid`` is the cloth's side (default 16, the JAX
example's grid); ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.config import ClothConfig
from ..core.state import ClothParams, ClothState, init_cloth_state
from ..models import cloth

N_SUBSTEPS = 480       # one simulated second at 480 Hz
SEGMENT = 48
ITERS = 8
TARGET_Y = 30.0        # want the COM at 30 after 1 s
LR = 0.5
# analytic answer for pure free fall: g = -2 * 10 / 1² = -20


def rollout(state0: ClothState, base: ClothParams, gravity: torch.Tensor,
            dt: torch.Tensor, use_kernel: bool, n_substeps: int = N_SUBSTEPS,
            segment: int = SEGMENT) -> torch.Tensor:
    """Mean height of the cloth after ``n_substeps`` from ``state0`` under
    ``gravity``."""
    params = base._replace(gravity=gravity)
    if use_kernel:
        s = cloth.multi_step_diff(state0, params, dt, n_substeps,
                                  segment=segment)
        return s.pos[1].mean()

    def step(pos, vel, g):
        out = cloth.substep(ClothState(pos=pos, vel=vel),
                            base._replace(gravity=g), dt)
        return out.pos, out.vel

    pos, vel = state0.pos, state0.vel
    for _ in range(n_substeps):
        # recompute each substep in the backward: memory O(n_substeps) states
        pos, vel = checkpoint(step, pos, vel, gravity, use_reentrant=False)
    return pos[1].mean()


def fit_gravity(grid: int = 16, device="cuda", use_kernel: bool = False,
                n_substeps: int = N_SUBSTEPS, iters: int = ITERS,
                segment: int = SEGMENT) -> List[Tuple[float, float]]:
    """Gradient descent on gravity; returns ``(loss, gravity)`` after each
    iteration."""
    c = ClothConfig(height=grid, width=grid)
    state0 = init_cloth_state(c, device=device)      # flat sheet at y = 40
    base = ClothParams.from_config(c, device=device)
    dt = torch.tensor(1.0 / 480.0, dtype=torch.float32, device=device)
    g = torch.tensor(-9.81, dtype=torch.float32, device=device)
    history = []
    for i in range(iters):
        g = g.detach().requires_grad_(True)
        y = rollout(state0, base, g, dt, use_kernel, n_substeps, segment)
        loss = (y - TARGET_Y) ** 2
        (dg,) = torch.autograd.grad(loss, g)
        g = g.detach() - LR * dg
        history.append((float(loss.detach()), float(g)))
        print(f"iter {i}: loss {history[-1][0]:9.5f}  gravity "
              f"{history[-1][1]:8.4f}  (analytic -20)")
    return history


def main(argv=None) -> List[Tuple[float, float]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", action="store_true",
                    help="differentiate through models.cloth.multi_step_diff")
    ap.add_argument("--grid", type=int, default=16, help="cloth side")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return fit_gravity(args.grid, torch.device(args.device), args.kernel)


if __name__ == "__main__":
    main()
