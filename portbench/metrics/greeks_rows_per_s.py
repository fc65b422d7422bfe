"""greeks_rows_per_s: payoff rows whose price and sensitivities are
computed a second in conv960.greeks, every row of the window over the
window's host time."""
from portbench import readers


def read(run):
    return readers.rows_per_s(run)
