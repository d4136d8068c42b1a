"""Shared arithmetic of the metric readers."""
from __future__ import annotations

import numpy as np


def p95(values):
    """The 95th percentile (linear between ranks), or None."""
    return float(np.percentile(values, 95)) if len(values) else None
