"""Ideal bytes of a c2c1024 call: the input read once, the spectrum and
the reconstruction written once."""


def ideal_bytes(sizes, traffic) -> int:
    item = {"complex128": 16, "complex64": 8}[sizes["dtype"]]
    return 3 * traffic["rows"] * sizes["n"] * item
