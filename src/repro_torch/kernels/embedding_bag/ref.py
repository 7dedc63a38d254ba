"""Plain PyTorch version of the weighted bag lookup-reduce."""
from __future__ import annotations

from typing import Optional

import torch


def embedding_bag_ref(
    ids: torch.Tensor,  # int [N, L]; -1 = pad
    weights: Optional[torch.Tensor],  # f32 [N, L], or None for all ones
    table: torch.Tensor,  # f32 [V, D]
) -> torch.Tensor:
    """out[n] = sum_l weights[n, l] * table[ids[n, l]], where an id of -1,
    or any id outside [0, V), adds 0 — the Pallas kernel's rule
    (``repro.kernels.embedding_bag``; its ``ref.py`` drops -1 but gathers
    NaN for an id at or past V).  Materialises the [N, L, D] gather: f32
    [N, D]."""
    if table.shape[0] == 0:  # every id is outside [0, V)
        return table.new_zeros((ids.shape[0], table.shape[1]))
    live = (ids >= 0) & (ids < table.shape[0])
    w = torch.ones(ids.shape, dtype=table.dtype, device=ids.device) \
        if weights is None else weights.to(table.dtype)
    w = torch.where(live, w, torch.zeros((), dtype=w.dtype, device=w.device))
    g = table[torch.where(live, ids, 0).long()]  # [N, L, D]
    return (g * w[..., None]).sum(dim=1)


def sequential_bag_sum(ids: torch.Tensor, table: torch.Tensor
                       ) -> torch.Tensor:
    """The unweighted bag sum in the kernel's order: ascending l, f32 adds
    of the live rows from +0 (an id outside [0, V) adds +0).  The kernel's
    unweighted output equals it bit for bit: f32 [N, D]."""
    live = (ids >= 0) & (ids < table.shape[0])
    acc = table.new_zeros((ids.shape[0], table.shape[1]))
    for j in range(ids.shape[1]):
        x = table[torch.where(live[:, j], ids[:, j], 0).long()]
        acc = acc + torch.where(live[:, j, None], x, 0.0)
    return acc
