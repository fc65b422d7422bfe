"""Ideal bytes of an fft2_4096 call, a rank: its block of the images read
once and its rows of the spectrum written once (HBM), and the bytes it
sends over the links: each of the two exchanges keeps 1/ranks of the
block on the rank and sends the rest."""


def _block_bytes(sizes) -> int:
    item = {"complex64": 8, "complex128": 16}[sizes["dtype"]]
    return sizes["images"] * (sizes["n0"] // sizes["ranks"]) * sizes["n1"] \
        * item


def ideal_bytes(sizes, traffic) -> int:
    return 2 * _block_bytes(sizes)


def link_bytes(sizes, traffic) -> int:
    d = sizes["ranks"]
    return 2 * _block_bytes(sizes) * (d - 1) // d
