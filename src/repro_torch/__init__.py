"""repro_torch — SSumM (KDD 2020) graph summarization in PyTorch for NVIDIA Hopper.

A port of the JAX package ``repro`` (the reference it is tested against).
Plain tensor code is PyTorch; the two TPU kernels of the reference have
hand-written Hopper counterparts in :mod:`repro_torch.kernels`. Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
