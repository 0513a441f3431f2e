"""Evaluation metrics — the port's own copy of what the Trainer's inline
validation needs from ``mdn_sfm_tpu.metrics``. The rest comes with the eval
CLIs."""

from __future__ import annotations

import numpy as np


def binary_image(x: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Binarize a probability map."""
    return (x >= threshold).astype(x.dtype if np.issubdtype(x.dtype, np.floating) else np.float32)
