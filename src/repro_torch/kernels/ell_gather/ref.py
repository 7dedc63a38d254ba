"""Plain PyTorch version of the doc-parallel ELL gather scoring kernel."""
from __future__ import annotations

import torch

# Docs gathered per step, times batch and slots: bounds the [B, n, K]
# gather to 2^24 floats.
_SLAB_ELEMS = 1 << 24


def ell_gather_ref(
    qw: torch.Tensor,  # f32 or bf16 [B, V]
    terms: torch.Tensor,  # int32 [N_pad, K], ids outside [0, V) are padding
    values: torch.Tensor,  # qw's dtype [N_pad, K]
) -> torch.Tensor:
    """out[b, n] = sum_k values[n, k] * qw[b, terms[n, k]] over slots whose
    id lies in [0, V) (``repro.kernels.ell_gather.ref``, where padding ids
    ``V`` read an appended zero row): [B, N_pad] in ``qw``'s dtype.  bf16
    operands are widened to f32 (every product exact), summed in f32 and
    each score rounded once to bf16, the kernel's contract."""
    if qw.dtype == torch.bfloat16:
        return ell_gather_ref(qw.float(), terms,
                              values.float()).to(torch.bfloat16)
    b, v = qw.shape
    n, k = terms.shape
    live = (terms >= 0) & (terms < v)
    t = torch.where(live, terms, 0).long()
    w = torch.where(live, values, 0.0)
    out = torch.empty((b, n), dtype=torch.float32, device=qw.device)
    step = max(1, _SLAB_ELEMS // max(b * k, 1))
    for s in range(0, n, step):
        g = qw[:, t[s:s + step]]  # [B, n_s, K]
        out[:, s:s + step] = (g * w[s:s + step]).sum(dim=-1)
    return out
