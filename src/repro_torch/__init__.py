"""repro_torch: the exact learned-sparse retrieval loop on PyTorch + CUDA.

The PyTorch port of :mod:`repro` (which stays the JAX reference).  It
imports ``torch``, numpy and the standard library only — never ``jax``
and nothing of ``repro``.

Importing the package turns TF32 off for float32 matrix products and
convolutions, process-wide: ``score_dense`` is the f32 oracle the kernels
are held against, and TF32 keeps only about three decimal digits.

Device rule: every entry point takes ``device`` (default ``"cuda"``); it
raises when no card is present rather than running on the CPU.  A kernel
wrapper runs its plain PyTorch version for a CPU tensor and its CUDA
kernel for a CUDA tensor, and never falls back from one to the other.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
