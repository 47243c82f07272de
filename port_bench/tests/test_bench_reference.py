"""The benchmark's reference and its comparison, on the CPU at small
sizes: the reference equals the program's plain versions, and the
comparison fails the bfloat16 control, each planted fault, and a window
whose kernels did not launch."""

import importlib
import random

import pytest
import torch

from conftest import WORKLOADS, fake_launches, run_small, small_spec


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_equals_plain_versions(workload, monkeypatch):
    fake_launches(monkeypatch)
    out = run_small(small_spec(workload))
    assert out["correct"], out["checks"]
    for name, c in out["checks"].items():
        if name.endswith("_launches"):
            continue
        if name.startswith("grad_rel_gap."):  # adjoint against forward mode
            assert c["value"] < 1e-5, c
        else:
            assert c["value"] == 0.0, (name, c)


def test_window_without_launches_fails():
    out = run_small(small_spec("datagen4096-states"))
    assert not out["correct"]
    assert out["checks"]["k5r_launches"]["value"] == 0
    assert out["failed"] == out["attempted"]


def _cell(workload, seed=7):
    spec = small_spec(workload)
    drv = importlib.import_module("port_bench.drivers."
                                  + spec["traffic"]["driver"])
    cell = drv.Cell(spec["config"], spec["traffic"], seed, "cpu")
    cell.warm_up()
    cell.plan(random.Random(seed))
    it = cell.units()
    for _ in range(4):
        next(it)
    it.close()
    cell.free()
    return cell, spec["traffic"]["limits"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails(workload):
    cell, limits = _cell(workload)
    got = cell.check(control=torch.bfloat16)
    assert any(v > limits[k] for k, v in got.items()), got


def _unchanged(state, *args, **kwargs):
    return state


def _answer_altered(monkeypatch, workload):
    from wgpu_physics_engine_torch.ops import cloth_kernel, cloth_grad_kernel
    from wgpu_physics_engine_torch.parallel import codec

    if workload == "datagen4096-codec":
        enc = codec.encode

        def bad(*a, **k):
            out = enc(*a, **k).clone()
            out[..., 0] += 8          # a DC step: 16 grey levels a block
            return out
        monkeypatch.setattr(codec, "encode", bad)
    elif workload == "cloth256-grad":
        walk = cloth_grad_kernel.walk

        def bad(*a, **k):
            cp, cv, g, ct = walk(*a, **k)
            return cp, cv, g * 1.01, ct
        monkeypatch.setattr(cloth_grad_kernel, "walk", bad)
    else:
        step = cloth_kernel.multi_step_packed

        def bad(*a, **k):
            s = step(*a, **k)
            return s._replace(pos=s.pos + 0.01)
        monkeypatch.setattr(cloth_kernel, "multi_step_packed", bad)


def _stiffness_partial_altered(monkeypatch):
    """The adjoint's structural-stiffness partial alone ×1.01: gravity's
    gradient and the loss stay as they were."""
    from wgpu_physics_engine_torch.ops import cloth_grad_kernel

    walk = cloth_grad_kernel.walk

    def bad(*a, **k):
        cp, cv, g, ct = walk(*a, **k)
        return cp, cv, g * torch.tensor([1.01] + [1.0] * 15,
                                        dtype=g.dtype), ct
    monkeypatch.setattr(cloth_grad_kernel, "walk", bad)


def _half_mean(monkeypatch, workload):
    from wgpu_physics_engine_torch.examples import differentiable_cloth as dc

    rollout = dc.rollout

    def bad(state0, base, gravity, dt, use_kernel, n, segment):
        h = state0.pos.shape[-2]
        half = state0._replace(pos=state0.pos[:, :h // 2],
                               vel=state0.vel[:, :h // 2])
        return rollout(half, base, gravity, dt, use_kernel, n, segment)
    monkeypatch.setattr(dc, "rollout", bad)


FAULTS = [(w, "state_unchanged") for w in WORKLOADS] + \
         [(w, "answer_altered") for w in WORKLOADS] + \
         [("cloth256-grad", "half_mean"), ("cloth256-sim", "not_a_number"),
          ("cloth256-grad", "stiffness_partial_altered")]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_planted_fault_fails(workload, fault, monkeypatch):
    from wgpu_physics_engine_torch.ops import cloth_kernel

    fake_launches(monkeypatch)
    if fault == "state_unchanged":
        monkeypatch.setattr(cloth_kernel, "multi_step_packed", _unchanged)
    elif fault == "answer_altered":
        _answer_altered(monkeypatch, workload)
    elif fault == "stiffness_partial_altered":
        _stiffness_partial_altered(monkeypatch)
    elif fault == "not_a_number":
        step = cloth_kernel.multi_step_packed

        def nan(*a, **k):
            s = step(*a, **k)
            return s._replace(pos=s.pos * float("nan"))
        monkeypatch.setattr(cloth_kernel, "multi_step_packed", nan)
    else:
        _half_mean(monkeypatch, workload)
    out = run_small(small_spec(workload))
    assert not out["correct"], out["checks"]


def test_a_gap_that_is_not_a_number_is_the_worst():
    from port_bench.harness import worst

    assert worst(0.0, 2.0) == 2.0
    assert worst(float("nan"), 1.0) != worst(float("nan"), 1.0)
    assert worst(3.0, float("inf")) == float("inf")


def test_reference_substep_bfloat16_runs():
    from port_bench.reference import cloth as ref

    cfg = small_spec("cloth256-sim")["config"]["cloth"]
    pos = ref.init_grid(cfg, "cpu")
    prm = ref.pack(cfg, 1 / 480, "cpu")
    p32, _ = ref.multi_step(pos, torch.zeros_like(pos), prm, 8)
    p16, _ = ref.multi_step(pos, torch.zeros_like(pos), prm, 8,
                            torch.bfloat16)
    assert torch.isfinite(p16).all() and (p16 - p32).abs().max() > 0
