"""Plain PyTorch reference of the datagen frame codec: JPEG's transform
stage at a fixed rate. Each 8x8 block of a channel, centred to [-128,
127], goes through the orthonormal DCT-II; the coefficients are divided
by the JPEG Annex K luminance table (times ``quality``), the ``k`` lowest
in zigzag order are kept, rounded half to even and clamped to int8.

A frozen copy of the engine's encoder: the DCT is two small matrix
products in float32 with TF32 off. ``dtype`` bfloat16 gives the control.
"""

from __future__ import annotations

import numpy as np
import torch

QTABLE = np.asarray([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.float32)


def dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II: coefficients = D . block . D^T."""
    x = np.arange(8)
    d = 0.5 * np.cos(np.pi * (2 * x[None, :] + 1) * x[:, None] / 16)
    d[0] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)


def zigzag() -> np.ndarray:
    """The 64 block positions in JPEG zigzag order."""
    idx = sorted(((u + v, (v if (u + v) % 2 == 0 else u), u, v)
                  for u in range(8) for v in range(8)))
    return np.asarray([u * 8 + v for _, _, u, v in idx], np.int64)


def encode(images: torch.Tensor, k: int, quality: float = 1.0,
           dtype=torch.float32) -> torch.Tensor:
    """uint8 ``[B, H, W, C]`` → int8 ``[B, H/8, W/8, C, k]``."""
    b, h, w, c = images.shape
    dev = images.device
    x = images.to(torch.float32).to(dtype) - 128.0
    x = x.reshape(b, h // 8, 8, w // 8, 8, c)
    x = torch.movedim(x, (2, 4), (4, 5))          # [B, H/8, W/8, C, 8, 8]
    d = torch.as_tensor(dct_matrix(), device=dev).to(dtype)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        coef = torch.einsum("ux,...xy,vy->...uv", d, x, d)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    flat = coef.reshape(b, h // 8, w // 8, c, 64)
    kept = flat[..., torch.as_tensor(zigzag()[:k], device=dev)]
    q = torch.as_tensor(QTABLE[zigzag()[:k]] * quality, device=dev).to(dtype)
    return torch.clamp(torch.round(kept / q), -127, 127).to(torch.int8)
