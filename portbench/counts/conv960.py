"""Ideal bytes of a conv960 call: each input byte read once and each
output byte written once, whatever implements the call."""


def ideal_bytes(sizes, traffic) -> int:
    n, rows = sizes["n"], traffic["rows"]
    item = 4 if sizes["dtype"] == "float32" else 8
    filt = 2 * (n // 2 + 1) * item              # phi_r, phi_i
    if traffic["call"] == "grad":
        # v, the cotangent and the filter in; out, grad v and the
        # filter's gradient out
        return 4 * rows * n * item + 2 * filt
    return 2 * rows * n * item + filt           # v and the filter in, out
