"""Metrics and logging: the counterpart of
``wgpu_physics_engine_tpu/utils/metrics.py``.

* standard-library ``logging`` integration (:func:`get_logger`);
* :func:`log_run_header` — the torch version and, where CUDA is present,
  the card's name and power limit, for reproducibility.
"""

from __future__ import annotations

import logging
import subprocess


def get_logger(name: str = "wpe_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card, or
    "" where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0].strip() if out.strip() else ""


def log_run_header(logger: logging.Logger | None = None) -> None:
    """Log the torch version and CUDA build, and where CUDA is present
    each card's name and the first card's power limit."""
    import torch

    logger = logger or get_logger()
    if torch.cuda.is_available():
        names = [torch.cuda.get_device_name(i)
                 for i in range(torch.cuda.device_count())]
        logger.info("torch %s | cuda %s | devices %s | %s", torch.__version__,
                    torch.version.cuda, names,
                    card_name_and_power_limit() or "power limit not read")
    else:
        logger.info("torch %s | cuda %s | no CUDA device (cpu)",
                    torch.__version__, torch.version.cuda)
