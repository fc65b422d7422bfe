"""k5_roofline.c2c1m: K5's bytes a call (counts/c2c1m.py: each
direction's two input planes read once and its two output planes
written once) at the card's peak bandwidth (peaks.json) over the device
time a call of K5's kernels, in percent; None without the peak or
without K5's kernels."""
from portbench import readers, spec

K5 = ("sf_split_col_reg_kernel", "sf_split_col_kernel",
      "sf_split_row_kernel")


def read(run):
    us = readers.kernel_us(run, K5)
    if us is None or not run.peak_bytes_per_s:
        return None
    counts = spec.load_module(run.cell.counts, "counts")
    k5 = counts.k5_bytes(run.cell.sizes, run.cell.traffic)
    return 100.0 * k5 / run.peak_bytes_per_s / (us * 1e-6)
