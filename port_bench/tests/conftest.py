"""Fixtures of the benchmark's CPU tests: cells cut to a size a test run
holds, run through the harness on the CPU (the program's plain versions
in place of its kernels)."""

import copy
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402

WORKLOADS = ("datagen4096-codec", "cloth256-sim", "cloth256-grad",
             "datagen4096-states")


def small_spec(workload: str, worlds: int = 8, chunk: int = 4,
               side: int = 10, frame=(32, 32), big_side: int = 16):
    """The cell ``workload`` with its scale cut: a few small worlds, or a
    small sheet dropped from lower down, in contact with the globe by the
    end of its drape; three units sampled."""
    spec = harness.cell_spec(workload)
    cfg = copy.deepcopy(spec["config"])
    tr = copy.deepcopy(spec["traffic"])
    if "worlds" in cfg:
        cfg.update(worlds=worlds, world_chunk=chunk, frame=list(frame))
        cfg["cloth"]["particles_per_side"] = side
        cfg["settle_seconds"] = 0.05
        tr.update(sample_window=3, sample_frames=2, sample_worlds=3)
    else:
        cfg["cloth"]["particles_per_side"] = big_side
        cfg["drape_seconds"] = 1.5  # from y = 15 ± 5, onto the globe
        cfg["cloth"]["center"] = [0.0, 15.0, 0.0]
        tr.update(sample_window=tr["sample_units"], unit_seconds=0.05)
    spec["config"], spec["traffic"] = cfg, tr
    return spec


def fake_launches(monkeypatch):
    """Launch counters that rise on every read, as a card's would."""
    calls = {"n": 0}

    def read(names):
        calls["n"] += 1
        return {n: calls["n"] for n in names}

    monkeypatch.setattr(harness, "read_counters", read)


def run_small(spec, seed: int = 2**31 + 11, seconds: float = 0.5,
              device: str = "cpu"):
    return harness.run_cell(spec, seed, seconds, False, device,
                            time.perf_counter())


@pytest.fixture
def card():
    """The CUDA device, or a skip where this host has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
