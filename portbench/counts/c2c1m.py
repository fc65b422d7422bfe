"""Bytes of a c2c1m call.  Ideal: the input read once, the spectrum and
the reconstruction written once.  K5's: each direction's two input
planes (re, im) read once and its two output planes written once."""


def ideal_bytes(sizes, traffic) -> int:
    return 3 * traffic["rows"] * sizes["n"] * 8


def k5_bytes(sizes, traffic) -> int:
    return 4 * traffic["rows"] * sizes["n"] * 8
