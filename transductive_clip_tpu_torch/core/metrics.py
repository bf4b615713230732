"""Evaluation metrics (95% confidence interval, reference: src/utils.py:27-37)."""

from __future__ import annotations

import numpy as np


def compute_confidence_interval(data, axis=0):
    """Mean and 95% CI half-width of per-episode accuracies."""
    a = 1.0 * np.asarray(data)
    m = np.mean(a, axis=axis)
    std = np.std(a, axis=axis)
    pm = 1.96 * (std / np.sqrt(a.shape[axis]))
    return m, pm
