"""Profiling and timing helpers: the counterpart of
``wgpu_physics_engine_tpu/utils/profiling.py``.

* :func:`sync` — wait for the work feeding a tree of tensors
  (``torch.cuda.synchronize`` on each CUDA device it holds);
* :func:`timed` — best-of-N time of a call: CUDA events around it when its
  result lies on the card, the host clock otherwise;
* :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace;
* :func:`throughput` — particle-steps/s of any stepper.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Callable

import torch

from .checkpoint import _flatten


def _cuda_devices(tree) -> list:
    return sorted({leaf.device for _, leaf in _flatten(tree)
                   if isinstance(leaf, torch.Tensor)
                   and leaf.device.type == "cuda"}, key=str)


def sync(tree) -> None:
    """Block until every kernel queued on the CUDA devices of ``tree``'s
    tensors has finished; nothing to wait for on the CPU."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, warmup: int = 1, repeats: int = 3, **kw):
    """Best-of-N time of ``fn(*args, **kw)`` in seconds, and its last
    result. Where the result lies on a card, each repeat is timed by CUDA
    events recorded around the call on the current stream (the device
    time of the queue between them); otherwise by the host clock around
    the call and :func:`sync`."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kw)
        sync(out)
    best = float("inf")
    for _ in range(repeats):
        if out is not None and _cuda_devices(out):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            end.synchronize()
            sync(out)
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync(out)
            best = min(best, time.perf_counter() - t0)
    return best, out


@contextlib.contextmanager
def trace(logdir: str | None = None):
    """``torch.profiler`` over the block (CPU, and CUDA where present),
    writing ``trace.json`` (Chrome trace format) to ``logdir`` on exit
    (default: ``wpe_torch_trace`` under the temporary directory). Yields
    the profiler, whose ``key_averages()`` tabulate the ops."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "wpe_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def throughput(stepper: Callable, state, params, dt, n_steps: int,
               n_particles: int, **kw) -> float:
    """particle-steps/sec of a ``stepper(state, params, dt, n_steps)``."""
    best, _ = timed(stepper, state, params, dt, n_steps, **kw)
    return n_particles * n_steps / best
