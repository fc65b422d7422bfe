"""The number each check compares: the largest gap between the program's
output and the reference's, over the reference's largest value."""
from __future__ import annotations

import math


class MaxRel:
    """max |got - want| / max |want| over every pair added; a pair whose
    shapes differ, or a NaN, makes it infinite."""

    def __init__(self):
        self.diff = 0.0
        self.ref = 0.0

    def add(self, got, want):
        self.ref = max(self.ref, float(want.abs().max()))
        if got.shape != want.shape:
            self.diff = math.inf
            return
        d = float((got - want).abs().max())
        self.diff = max(self.diff, d if d == d else math.inf)

    def value(self) -> float:
        return self.diff / self.ref if self.ref > 0 else math.inf
