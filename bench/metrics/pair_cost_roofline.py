"""Pair-cost kernel (``kernels/entropy_bits.py`` through
``kernels/ops.py::pair_cost``, Triton): the share of its roofline over the
window's launches. Moves ``summarize_s``."""

from bench.roofline import share


def read(r):
    return share(r, "pair_cost", "_pair_cost_kernel")
