"""Checkpoint / resume for long runs: the counterpart of
``wgpu_physics_engine_tpu/utils/checkpoint.py``, in its ``.npz`` layout.

A state is a tree of NamedTuples, tuples, lists and dicts over tensors
(``None`` allowed), so a checkpoint is an ``.npz`` of its leaves in
order (``leaf_0``, ``leaf_1``, ...) plus the tree's structure as text
(``__treedef__``) and a JSON ``__meta__``, written atomically (a
temporary file renamed into place). The structure text is the JAX
package's (``str(jax.tree.structure(...))``: ``*`` a leaf, dict keys
sorted, a NamedTuple as ``CustomNode(namedtuple[Name], [...])``), so a
checkpoint of the same state loads in either package.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, List, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x) -> list:
    """``(path part, child)`` pairs of a container, in flattening order;
    dict keys sorted, as JAX flattens them."""
    if _is_namedtuple(x):
        return [(f".{f}", getattr(x, f)) for f in x._fields]
    if isinstance(x, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(x)]
    return [(f"[{k!r}]", x[k]) for k in sorted(x)]


def _is_container(x) -> bool:
    return isinstance(x, (tuple, list, dict))


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in JAX's order (``None`` is no leaf)."""
    if tree is None:
        return []
    if not _is_container(tree):
        return [(path, tree)]
    out = []
    for part, c in _children(tree):
        out += _flatten(c, path + part)
    return out


def treedef_str(tree) -> str:
    """The tree's structure in the JAX package's ``str(treedef)`` form."""
    def node(x) -> str:
        if x is None:
            return "None"
        if not _is_container(x):
            return "*"
        kids = [node(c) for _, c in _children(x)]
        if _is_namedtuple(x):
            return (f"CustomNode(namedtuple[{type(x).__name__}], "
                    f"[{', '.join(kids)}])")
        if isinstance(x, tuple):
            return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
        if isinstance(x, list):
            return "[" + ", ".join(kids) + "]"
        return "{" + ", ".join(f"{k!r}: {v}" for k, v in
                               zip(sorted(x), kids)) + "}"
    return f"PyTreeDef({node(tree)})"


def _unflatten(like, leaves: list):
    """``like`` with its leaves replaced, in order, by ``leaves``."""
    it = iter(leaves)

    def rebuild(x):
        if x is None:
            return None
        if not _is_container(x):
            return next(it)
        kids = [rebuild(c) for _, c in _children(x)]
        if _is_namedtuple(x):
            return type(x)(*kids)
        if isinstance(x, (tuple, list)):
            return type(x)(kids)
        return dict(zip(sorted(x), kids))
    return rebuild(like)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save(path: str, tree: Any, meta: dict | None = None) -> None:
    """Save a tree of tensors (or arrays) to ``path`` (.npz), atomically."""
    leaves = [leaf for _, leaf in _flatten(tree)]
    payload = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(leaves)}
    payload["__treedef__"] = np.frombuffer(treedef_str(tree).encode(),
                                           dtype=np.uint8)
    payload["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                        dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class CheckpointMismatchError(ValueError):
    """The checkpoint's structure/shape/dtype doesn't match ``like``."""


def _np_dtype(x) -> np.dtype:
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def load(path: str, like: Any, strict: bool = True,
         device=None) -> Tuple[Any, dict]:
    """Load a checkpoint saved by :func:`save` (or by the JAX package's
    ``checkpoint.save``). ``like`` gives the tree's structure (e.g. a
    freshly initialized state); each tensor leaf of ``like`` is replaced by
    the stored one on ``device`` (default: that leaf's device), any other
    leaf by a numpy array. Returns (tree, meta).

    With ``strict=True`` (default) the stored structure and every leaf's
    shape/dtype are validated against ``like``; a mismatch raises
    :class:`CheckpointMismatchError` naming the offending leaf."""
    flat_like = _flatten(like)
    n = len(flat_like)
    with np.load(path) as z:
        if strict:
            if "__treedef__" in z:
                stored = bytes(z["__treedef__"]).decode()
                want = treedef_str(like)
                if stored != want:
                    raise CheckpointMismatchError(
                        f"{path}: stored treedef\n  {stored}\n"
                        f"does not match `like`\n  {want}")
            n_stored = sum(1 for k in z.files if k.startswith("leaf_"))
            if n_stored != n:
                raise CheckpointMismatchError(
                    f"{path}: {n_stored} stored leaves, `like` has {n}")
        arrays = [z[f"leaf_{i}"] for i in range(n)]
        meta = (json.loads(bytes(z["__meta__"]).decode())
                if "__meta__" in z else {})
    leaves = []
    for (kp, want), got in zip(flat_like, arrays):
        if strict:
            want_shape = tuple(want.shape if isinstance(want, torch.Tensor)
                               else np.shape(want))
            want_dtype = _np_dtype(want)
            if tuple(got.shape) != want_shape or got.dtype != want_dtype:
                raise CheckpointMismatchError(
                    f"{path}: leaf {kp} is {got.shape}/{got.dtype}, `like` "
                    f"expects {want_shape}/{want_dtype}")
        if isinstance(want, torch.Tensor):
            leaves.append(torch.from_numpy(got).to(
                want.device if device is None else device))
        else:
            leaves.append(got)
    return _unflatten(like, leaves), meta
