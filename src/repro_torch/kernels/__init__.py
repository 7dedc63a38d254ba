"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel is a package, ``ref.py`` (the plain version) and ``ops.py``
(the entry: plain version for a CPU tensor, CUDA kernel for a CUDA
tensor), with its source in ``src/repro_torch/csrc/<name>.cu``, built on
first use by :mod:`repro_torch.kernels.build`.
"""
