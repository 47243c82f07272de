"""Profiling and timing helpers: the counterpart of
``wgpu_physics_engine_tpu/utils/profiling.py``.

* :func:`sync` — wait for the work feeding a tree of tensors
  (``torch.cuda.synchronize`` on each CUDA device it holds);
* :func:`timed` — best-of-N time of a call: CUDA events around it when its
  result lies on the card, the host clock otherwise;
* :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace;
* :func:`span` — the port's named ranges at its layer boundaries, free
  when no profiler records.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler

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
def trace(logdir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where present),
    writing ``trace.json`` (Chrome trace format) to the caller's
    ``logdir`` on exit. Yields the profiler, whose ``key_averages()``
    tabulate the ops."""
    os.makedirs(logdir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler records (on its clock, on the thread that opens it: autograd's
    device threads included), else one shared no-op context. The check
    reads the flag that ``torch.profiler`` sets for the process while it
    runs, so a disabled span costs a few tenths of a µs where a bare
    ``record_function`` costs ~5 µs with no profiler running. Open it once
    a call, never in a per-substep loop."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN
