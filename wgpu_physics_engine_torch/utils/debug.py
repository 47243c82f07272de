"""Numeric failure detection and debugging aids: the counterpart of
``wgpu_physics_engine_tpu/utils/debug.py``.

* :func:`assert_finite` — raise (with leaf paths) if any floating leaf of
  a tree of tensors holds NaN/Inf;
* :func:`checked` — wrap a stepper so that every call's output is checked
  for finite values right after the step (eager: the check reads the
  result back, a synchronization on the card);
* :func:`find_nan_step` — find the first substep at which a state goes
  non-finite.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .checkpoint import _flatten


def _finite(leaf) -> bool:
    """Whether a floating leaf holds only finite values (True for any
    other leaf)."""
    if isinstance(leaf, torch.Tensor):
        return not leaf.is_floating_point() or bool(torch.isfinite(leaf).all())
    arr = np.asarray(leaf)
    return arr.dtype.kind != "f" or bool(np.isfinite(arr).all())


def _n_bad(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return int((~torch.isfinite(leaf)).sum())
    return int((~np.isfinite(np.asarray(leaf))).sum())


def assert_finite(tree: Any, name: str = "state") -> None:
    """Raise ValueError naming the leaves that hold NaN/Inf."""
    bad = [f"{name}{path}: {_n_bad(leaf)} non-finite"
           for path, leaf in _flatten(tree) if not _finite(leaf)]
    if bad:
        raise ValueError("non-finite values detected:\n  " + "\n  ".join(bad))


def checked(step_fn: Callable) -> Callable:
    """Wrap ``step_fn(state, *a, **kw) -> state`` so that each call raises
    FloatingPointError if its output holds a non-finite floating value."""

    def wrapper(state, *args, **kwargs):
        out = step_fn(state, *args, **kwargs)
        if not all(_finite(leaf) for _, leaf in _flatten(out)):
            raise FloatingPointError(
                f"{getattr(step_fn, '__name__', 'step')} produced "
                "non-finite state")
        return out

    return wrapper


def find_nan_step(step_fn: Callable, state: Any, max_steps: int,
                  chunk: int = 64) -> int:
    """Return the first step index at which ``step_fn`` makes the state
    non-finite, or -1 if it stays finite for ``max_steps``. Runs in chunks,
    checking once a chunk, then replays the failing chunk step by step."""

    def finite(s) -> bool:
        return all(_finite(leaf) for _, leaf in _flatten(s))

    done = 0
    while done < max_steps:
        n = min(chunk, max_steps - done)
        nxt = state
        for _ in range(n):
            nxt = step_fn(nxt)
        if not finite(nxt):
            for i in range(n):
                state = step_fn(state)
                if not finite(state):
                    return done + i
        state = nxt
        done += n
    return -1
