"""fft2_images_per_s: images through the sharded forward 2-D FFT a second,
every image of the window's calls over the window's time (the largest
of the ranks' windows)."""
from portbench import readers


def read(run):
    return readers.images_per_s(run)
