"""setup_s: process start to the window's start: imports, the card, the
kernel library (built on a checkout's first run), the inputs and the
warm calls."""
from portbench import readers


def read(run):
    return readers.setup_s(run)
