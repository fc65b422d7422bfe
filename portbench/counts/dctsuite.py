"""Ideal bytes of a dctsuite call: each input byte read once and each
output byte written once, whatever implements the call.  A row of length
n reads n values and writes the packed spectrum's two planes of n/2 + 1
and seven rows of n (three reconstructions of the four, the DCT-II,
DST-II and DCT-IV, and the fourth reconstruction)."""


def ideal_bytes(sizes, traffic) -> int:
    item = {"float32": 4, "float64": 8}[sizes["dtype"]]
    per_row = sum(n + 2 * (n // 2 + 1) + 7 * n for n in sizes["lengths"])
    return traffic["rows"] * per_row * item
