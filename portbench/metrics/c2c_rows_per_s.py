"""c2c_rows_per_s: complex128 rows through the forward and inverse
transform a second, every row of the window over the window's host time."""
from portbench import readers


def read(run):
    return readers.rows_per_s(run)
