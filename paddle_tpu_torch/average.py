"""reference: python/paddle/fluid/average.py WeightedAverage."""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


class WeightedAverage:
    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight=1):
        arr = np.asarray(value, dtype=np.float64).ravel()
        if arr.size != 1:
            raise ValueError(
                f"WeightedAverage.add expects a scalar, got shape "
                f"{np.asarray(value).shape}; add per-sample values "
                "individually or pre-reduce them")
        self.numerator += float(arr[0]) * weight
        self.denominator += weight

    def eval(self):
        if self.denominator == 0:
            raise ValueError("no values added yet")
        return self.numerator / self.denominator
