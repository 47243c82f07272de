"""Granular system identification: the port of ``examples/inverse_granular.py``.

Recovers the contact stiffness, gravity and wall restitution of a granular
material from observed particle trajectories. They are 0-d tensors of
``models.granular.multi_step_diff``, so ``torch.autograd`` of a
trajectory-matching loss flows through the frozen broad-phase schedule, the
contact kernel (K11 forward, K12 for the transpose) and the wall-bounce
branches, and Adam fits all three jointly.

    python -m wgpu_physics_engine_torch.examples.inverse_granular \\
        [--device cuda|cpu] [--iters N]

The problem is the JAX example's: 400 particles in a unit box (radius
0.05, rebuild every 4 substeps, block 128, slab 256), settled 60 substeps
and then started hot (velocities × 8) so that wall bounces fire inside the
8-substep horizon (the restitution signal) while the pile stays in contact
(the stiffness signal). The fit starts 2× off in stiffness and gravity and
at e = 0.9 (true 0.5), with the JAX example's learning rate, 0.1 · 0.7^(step
/ 40). The initial jitter comes from a ``torch.Generator`` (the JAX
example's ``jax.random`` bits cannot be reproduced), so the pile is another
draw of the same lattice. ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional

import torch

from ..core.state import ParticleState
from ..models import granular

DT = 1.0 / 240.0


def make_problem(n: int = 400, n_steps: int = 8, seed: int = 11,
                 device="cuda"):
    """``(config, state, target, true, n_steps)``: the hot start, the
    trajectory at the true parameters it is fitted to, and those
    parameters."""
    config = granular.GranularConfig(
        num_particles=n, bounds=1.0, radius=0.05, rebuild_every=4,
        pallas_block=128, pallas_slab=256, grid_capacity=16)
    state = granular.init_state(config, torch.Generator().manual_seed(seed),
                                device=device)
    state = granular.multi_step(state, config, DT, 60)    # settle contacts
    # hot start: wall bounces inside the horizon carry the restitution signal
    state = ParticleState(pos=state.pos, vel=state.vel * 8.0)
    true = {k: torch.tensor(getattr(config, k), dtype=torch.float32,
                            device=device)
            for k in ("k_contact", "gravity", "restitution")}
    with torch.no_grad():
        target = granular.multi_step_diff(state, config, DT, n_steps, **true)
    return config, state, target, true, n_steps


def objective(theta: torch.Tensor, config, state, target, n_steps: int):
    """The loss at ``theta = (log k_contact, gravity / 10, restitution)``:
    each coordinate scaled so its plausible range is of order 1 (Adam's
    step is ~lr in parameter space). The velocity term carries the gravity
    signal (dv = g·t in free flight)."""
    out = granular.multi_step_diff(
        state, config, DT, n_steps, k_contact=torch.exp(theta[0]),
        gravity=10.0 * theta[1], restitution=theta[2])
    return (1e2 * torch.mean((out.pos - target.pos) ** 2)
            + 1e0 * torch.mean((out.vel - target.vel) ** 2))


def fit(config, state, target, true, n_steps: int, n_iters: int = 150,
        verbose: bool = True, losses: Optional[list] = None) -> dict:
    """Joint Adam fit of (log k_contact, gravity, restitution); appends
    each iteration's loss to ``losses`` and returns the recovered
    values."""
    dev = state.pos.device
    theta = torch.tensor([math.log(0.5 * float(true["k_contact"])),   # 2x off
                          0.05 * float(true["gravity"]),              # 2x off
                          0.9],                                       # true 0.5
                         dtype=torch.float32, device=dev, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 0.7 ** (s / 40))
    for i in range(n_iters):
        opt.zero_grad()
        loss = objective(theta, config, state, target, n_steps)
        loss.backward()
        opt.step()
        sched.step()
        if losses is not None:
            losses.append(float(loss.detach()))
        if verbose and i % 10 == 0:
            t = theta.detach()
            k, g, e = float(torch.exp(t[0])), float(10.0 * t[1]), float(t[2])
            print(f"  iter {i:3d}: loss {float(loss):.3e}  k {k:8.1f}  "
                  f"g {g:7.3f}  e {e:.3f}")
    with torch.no_grad():
        return {"k_contact": torch.exp(theta[0]), "gravity": 10.0 * theta[1],
                "restitution": theta[2].clone()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=150)
    args = ap.parse_args(argv)
    config, state, target, true, n_steps = make_problem(device=args.device)
    losses = []
    fitted = fit(config, state, target, true, n_steps, n_iters=args.iters,
                 losses=losses)
    print("  recovered vs true:")
    for name in ("k_contact", "gravity", "restitution"):
        f, t = float(fitted[name]), float(true[name])
        print(f"    {name:12s} {f:9.3f}  (true {t:9.3f}, "
              f"rel err {abs(f - t) / max(abs(t), 1e-9):.2%})")
    return fitted, true, losses


if __name__ == "__main__":
    main()
