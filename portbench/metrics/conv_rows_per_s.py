"""conv_rows_per_s: payoff rows priced a second, every row of the window
over the window's host time."""
from portbench import readers


def read(run):
    return readers.rows_per_s(run)
