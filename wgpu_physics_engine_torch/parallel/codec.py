"""Fixed-rate on-device frame codec ("JPEG-lite") for datagen egress: the
counterpart of ``wgpu_physics_engine_tpu/parallel/codec.py``.

Datagen's frames leave the card through the host link; this codec shrinks
them by 64/K with JPEG's transform stage but a FIXED rate instead of
entropy coding, so every frame batch has one static size:

1. center uint8 pixels to [-128, 127],
2. per channel, 8×8 block DCT-II (two small matrix products),
3. quantize by the standard JPEG luminance table (scaled by ``quality``),
4. keep the K lowest-frequency coefficients in zigzag order, round to int8.

:func:`encode` runs in torch on the frames' device. The DCT is a plain
``torch.einsum`` in fp32, as the JAX package leaves it to XLA, and runs with
TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False`` for the call):
TF32 keeps ~3 decimal digits, which would move coefficients across
rounding boundaries. ``torch.round`` rounds half to even, as ``jnp.round``
does. :func:`decode`, the sidecar (:func:`write_meta`, :func:`read_meta`)
and :func:`psnr` are NumPy, copied from the JAX module so that datasets from
either package decode the same.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..utils.profiling import span


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8×8 DCT-II matrix D: coefficients = D · block · Dᵀ."""
    x = np.arange(8)
    d = 0.5 * np.cos(np.pi * (2 * x[None, :] + 1) * x[:, None] / 16)
    d[0] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)


def _zigzag_order() -> np.ndarray:
    """Indices of the 64 block positions in JPEG zigzag scan order."""
    idx = sorted(((u + v, (v if (u + v) % 2 == 0 else u), u, v)
                  for u in range(8) for v in range(8)))
    return np.asarray([u * 8 + v for _, _, u, v in idx], np.int32)


# Standard JPEG luminance quantization table (Annex K), row-major.
_QTABLE = np.asarray([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.float32)

_DCT = _dct_matrix()
_ZZ = _zigzag_order()


def _quant(k: int, quality: float) -> np.ndarray:
    # the orthonormal 8-point DCT-II *is* JPEG's scaling convention (both
    # give DC = 8·mean), so the Annex-K table applies directly; quality
    # scales step sizes. At quality ≥ 1 every coefficient of a uint8 block
    # fits int8 after quantization (DC ∈ ±1024, q_DC = 16 → ±64).
    return (_QTABLE[_ZZ[:k]] * quality).astype(np.float32)


def encode(images: torch.Tensor, k: int = 16,
           quality: float = 1.0) -> torch.Tensor:
    """Encode ``[..., H, W, C]`` uint8 (or [0, 255] float) framebuffers to
    ``[..., H/8, W/8, C, k]`` int8 DCT coefficients, on their device.

    ``quality`` ≥ 1 scales quantization step sizes (bigger = coarser);
    below 1 the DC coefficient can saturate int8 — don't."""
    with span("codec.encode"):
        h, w, c = images.shape[-3:]
        lead = tuple(images.shape[:-3])
        dev = images.device
        x = images.to(torch.float32) - 128.0
        x = x.reshape(lead + (h // 8, 8, w // 8, 8, c))
        nlead = len(lead)
        # -> [..., H/8, W/8, C, 8, 8]
        x = torch.movedim(x, (nlead + 1, nlead + 3), (nlead + 3, nlead + 4))
        d = torch.as_tensor(_DCT, device=dev)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            coef = torch.einsum("ux,...xy,vy->...uv", d, x, d)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        flat = coef.reshape(lead + (h // 8, w // 8, c, 64))
        kept = flat[..., torch.as_tensor(_ZZ[:k], dtype=torch.int64,
                                         device=dev)]
        q = torch.as_tensor(_quant(k, quality), device=dev)
        return torch.clamp(torch.round(kept / q), -127, 127).to(torch.int8)


def decode(coeffs: np.ndarray, quality: float = 1.0) -> np.ndarray:
    """NumPy inverse of :func:`encode` for dataset consumers:
    ``[..., H/8, W/8, C, k]`` int8 → ``[..., H, W, C]`` uint8."""
    coeffs = np.asarray(coeffs)
    k = coeffs.shape[-1]
    *lead, hb, wb, c, _ = coeffs.shape
    full = np.zeros((*lead, hb, wb, c, 64), np.float32)
    full[..., _ZZ[:k]] = coeffs.astype(np.float32) * _quant(k, quality)
    blocks = full.reshape(*lead, hb, wb, c, 8, 8)
    x = np.einsum("xu,...uv,yv->...xy", _DCT.T, blocks, _DCT.T)
    nlead = len(lead)
    # [..., hb, wb, c, 8, 8] -> [..., hb, 8, wb, 8, c]
    x = np.moveaxis(x, (nlead + 3, nlead + 4), (nlead + 1, nlead + 3))
    img = x.reshape(*lead, hb * 8, wb * 8, c) + 128.0
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


CODEC_VERSION = 1
_META_NAME = "codec_meta.json"


def write_meta(dirpath: str, k: int, quality: float,
               fb_size) -> str:
    """Write the self-describing sidecar (``codec_meta.json``) next to a
    run's encoded shards. ``quality`` is NOT recoverable from shard shapes
    — decoding with the wrong value silently rescales pixel magnitudes —
    so every datagen run records it here and :func:`read_meta` refuses to
    guess."""
    meta = {"codec_version": CODEC_VERSION, "k": int(k),
            "quality": float(quality),
            "fb_size": [int(x) for x in fb_size]}
    path = os.path.join(dirpath, _META_NAME)
    with open(path, "w") as f:
        json.dump(meta, f)
    return path


def read_meta(dirpath: str) -> dict:
    """Read a run's codec sidecar. Raises ``FileNotFoundError`` when the
    directory has none and ``ValueError`` on an unknown codec version."""
    path = os.path.join(dirpath, _META_NAME)
    with open(path) as f:
        meta = json.load(f)
    if meta.get("codec_version") != CODEC_VERSION:
        raise ValueError(
            f"{path}: codec_version {meta.get('codec_version')!r} != "
            f"{CODEC_VERSION} (shards from an incompatible encoder)")
    return meta


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Peak signal-to-noise ratio between two uint8 images, in dB."""
    mse = np.mean((np.asarray(a, np.float32) - np.asarray(b, np.float32)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(255.0 ** 2 / mse))
