"""xDeepFM [arXiv:1803.05170] (``repro.models.recsys.xdeepfm``):
Compressed Interaction Network (CIN) + deep MLP + linear term.

CIN level k: z^k[b,h,f,d] = x^k[b,h,d] * x^0[b,f,d] (an outer product per
embedding dim), compressed by filters W^k [H_k F, H_{k+1}]; each level is
sum-pooled over the embedding dim for the final logit.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.recsys.embeddings import (
    ClickModel, FieldEmbedding, apply_mlp_tower, init_mlp_tower,
)
from repro_torch.utils import resolve_device


class XDeepFM(ClickModel):
    """Parameters under the JAX names: ``fields.table``, ``linear.table``
    [rows, 1], ``cin.<k>``, ``w_cin``, ``mlp.*`` and ``b_out``; on
    ``device`` (default ``"cuda"``: raises without a card), drawn from
    ``generator`` with the JAX init's laws (other numbers: carry JAX
    weights with ``params_from_jax``)."""

    def __init__(self, cfg: RecsysConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        self.embedding = FieldEmbedding(cfg.vocab_sizes, cfg.embed_dim)
        f = cfg.n_sparse
        self.fields = self.embedding.init(gen, dev)
        self.linear = nn.ParameterDict({"table": nn.Parameter(dense_init(
            gen, self.embedding.total_rows, 1, scale=0.01, device=dev))})
        cin, h_prev = [], f
        for h_k in cfg.cin_layers:
            cin.append(nn.Parameter(dense_init(gen, h_prev * f, h_k,
                                               device=dev)))
            h_prev = h_k
        self.cin = nn.ParameterList(cin)
        self.w_cin = nn.Parameter(dense_init(gen, sum(cfg.cin_layers), 1,
                                             device=dev))
        self.mlp = init_mlp_tower(gen, (f * cfg.embed_dim, *cfg.mlp_dims), 1,
                                  device=dev)
        self.b_out = nn.Parameter(torch.zeros(1, device=dev))

    def _cin(self, x0: torch.Tensor) -> torch.Tensor:
        """x0 [B, F, D] -> concat of sum-pooled CIN levels [B, sum(H_k)]."""
        b, f, d = x0.shape
        pooled = []
        xk = x0
        for w in self.cin:
            hk = xk.shape[1]
            z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(b, hk * f, d)
            xk = torch.relu(torch.einsum("bzd,zo->bod", z, w))  # [B, H, D]
            pooled.append(xk.sum(dim=-1))
        return torch.cat(pooled, dim=-1)

    def forward(self, batch: dict, use_kernel: bool = True) -> torch.Tensor:
        """``batch["sparse_ids"]`` [B, F] or [B, F, H] -> logits [B]."""
        table = self.fields["table"]
        ids = batch["sparse_ids"].to(table.device)
        x0 = self.embedding.lookup(table, ids, use_kernel)
        cin_out = self._cin(x0) @ self.w_cin  # [B, 1]
        deep = apply_mlp_tower(self.mlp, x0.reshape(x0.shape[0], -1))
        if ids.dim() == 3:
            ids = ids[:, :, 0]  # the linear term reads a bag's first id
        offs = torch.from_numpy(self.embedding.offsets).to(ids.device)
        lin = self.linear["table"][(ids + offs[None, :]).long()].sum(
            dim=(1, 2))
        return (cin_out + deep)[:, 0] + lin + self.b_out[0]

    def score_candidates(self, batch: dict, candidate_ids: torch.Tensor,
                         use_kernel: bool = True) -> torch.Tensor:
        """Retrieval scores [B, C]: the user's field sum dotted with each
        candidate's embedding in field 0 (the item field)."""
        table = self.fields["table"]
        x0 = self.embedding.lookup(table, batch["sparse_ids"], use_kernel)
        u = x0.sum(dim=1)  # [B, D]
        cand = table[int(self.embedding.offsets[0])
                     + candidate_ids.to(table.device).long()]
        return u @ cand.T
