"""Distributed system identification: the port of
``examples/multichip_training.py``.

A batch of worlds (data parallel) of row-sharded cloths (halo exchange) is
rolled out through ``parallel.mesh.batched_spatial_multi_step``; autograd
of the trajectory-matching loss flows through the sharded stepper, whose
halo exchange adds each halo row's cotangent back onto its owner and sums
the parameter cotangents over the shards (the data-parallel all-reduce of
JAX's ``shard_map`` transpose), and Adam recovers the structural spring
stiffness that produced the observed trajectories.

    python -m wgpu_physics_engine_torch.examples.multichip_training \\
        [--device cuda|cpu] [--shards 8] [--iters 60]

``--shards`` shards (default 8) go round-robin over the device's cards
(``multichip_datagen.shard_devices``): 8 shards of ``cuda:0`` on one card,
two each on four. ``--device cpu`` makes them CPU shards. A shard's window
runs K1w and, under autograd, the window adjoint (``ops/csrc/cloth_grad.cu``)
on the card, their plain versions on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch

from ..core.config import ClothConfig
from ..core.state import ClothParams, ClothState, init_cloth_state
from ..parallel import mesh as pmesh
from .multichip_datagen import shard_devices

DT = 1.0 / 480.0
N_STEPS = 16
SUBSTEPS_PER_EXCHANGE = 2
# optax.adam(optax.exponential_decay(0.05, 12, 0.7)) of the JAX example
LR, DECAY_STEPS, DECAY_RATE = 0.05, 12, 0.7
SEED = 7


def make_problem(n_devices: int = 8, height: int = 16, width: int = 16,
                 worlds_per_shard: int = 2,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
    """The mesh, config, parameters and start state: ``n_devices`` shards
    as a ``(n/2, 2)`` worlds × rows mesh (``(n, 1)`` for odd n),
    ``worlds_per_shard`` worlds a worlds shard, each the config's cloth
    plus 0.3·N(0, 1) noise from ``generator`` (default seeded with
    :data:`SEED`) on the CPU, then moved to ``device``."""
    devices = shard_devices(device, n_devices)
    rows = 2 if len(devices) % 2 == 0 else 1
    worlds = len(devices) // rows
    m = pmesh.make_mesh((worlds, rows), ("worlds", "rows"), devices)

    c = ClothConfig(height=height, width=width)
    dev = devices[0]
    params = ClothParams.from_config(c, device=dev)
    base = init_cloth_state(c, device="cpu")
    b = worlds_per_shard * worlds
    g = generator if generator is not None else (
        torch.Generator().manual_seed(SEED))
    # per-world perturbations: stretched springs carry the stiffness signal
    noise = 0.3 * torch.randn((b,) + tuple(base.pos.shape), generator=g)
    state = ClothState(pos=(torch.stack([base.pos] * b) + noise).to(dev),
                       vel=torch.zeros((b,) + tuple(base.vel.shape),
                                       device=dev))
    return m, c, params, state


def rollout(state: ClothState, params: ClothParams, m: pmesh.Mesh,
            n_steps: int = N_STEPS) -> ClothState:
    """``n_steps`` substeps of the batch on ``m``, a halo exchange every
    :data:`SUBSTEPS_PER_EXCHANGE` substeps."""
    return pmesh.batched_spatial_multi_step(
        state, params, DT, n_steps, m,
        substeps_per_exchange=SUBSTEPS_PER_EXCHANGE)


def loss_fn(log_k: torch.Tensor, state: ClothState, params: ClothParams,
            m: pmesh.Mesh, target: ClothState) -> torch.Tensor:
    """``1e3 · mean((pos − target)²)`` after a rollout with ``k_struct =
    exp(log_k)``."""
    out = rollout(state, params._replace(k_struct=torch.exp(log_k)), m)
    return 1e3 * torch.mean((out.pos - target.pos) ** 2)


def make_optimizer(log_k: torch.Tensor):
    """Adam at ``LR · DECAY_RATE^(t / DECAY_STEPS)`` for update t (from 0):
    ``optax.exponential_decay(0.05, 12, 0.7)``, smooth, not a staircase.
    Returns ``(optimizer, scheduler)``; step the scheduler after each
    update."""
    opt = torch.optim.Adam([log_k], lr=LR)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: DECAY_RATE ** (t / DECAY_STEPS))
    return opt, sched


def main(n_iters: int = 60, n_devices: int = 8,
         device="cuda") -> Tuple[float, float]:
    """Fit ``k_struct`` from a start 2× off; returns ``(k, k_true)``."""
    m, c, params, state = make_problem(n_devices, device=device)
    k_true = params.k_struct
    with torch.no_grad():
        target = rollout(state, params, m)

    log_k = torch.log(0.5 * k_true).detach().requires_grad_(True)
    opt, sched = make_optimizer(log_k)
    for i in range(n_iters):
        opt.zero_grad()
        loss = loss_fn(log_k, state, params, m, target)
        loss.backward()
        opt.step()
        sched.step()
        if i % 5 == 0:
            print(f"  iter {i:3d}: loss {float(loss.detach()):.3e}  "
                  f"k_struct {float(torch.exp(log_k.detach())):9.2f} "
                  f"(true {float(k_true):.1f})")
    k = float(torch.exp(log_k.detach()))
    print(f"  recovered k_struct {k:.2f} (true {float(k_true):.1f}, "
          f"started {0.5 * float(k_true):.1f})")
    return k, float(k_true)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--iters", type=int, default=60)
    a = ap.parse_args()
    main(a.iters, a.shards, a.device)
