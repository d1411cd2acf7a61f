"""Hand-written Hopper kernels of the port, their plain versions and their seam.

``merge_gain`` (CUDA C++, ``csrc/merge_gain.cu``) replaces
``repro/kernels/merge_gain.py::merge_gain_pallas``; ``entropy_bits`` (Triton)
replaces ``repro/kernels/entropy_bits.py::pair_cost_pallas``. Callers go
through :mod:`repro_torch.kernels.ops`. Nothing is built or compiled when
these modules are imported.
"""
