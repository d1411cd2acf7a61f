"""Merge-gain kernel (``kernels/csrc/merge_gain.cu`` through
``kernels/ops.py::merge_gain``): the share of its roofline over the window's
launches. Moves ``summarize_s``."""

from bench.roofline import share


def read(r):
    return share(r, "merge_gain", "merge_gain_kernel")
