"""Headless frame output: PNG frames and animated GIFs (NumPy and PIL; the
same functions as ``wgpu_physics_engine_tpu/utils/viewer.py``)."""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(img: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(to_uint8(img)).save(path)


def save_gif(frames: Iterable[np.ndarray], path: str, fps: int = 30) -> None:
    from PIL import Image

    ims = [Image.fromarray(to_uint8(f)) for f in frames]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)
