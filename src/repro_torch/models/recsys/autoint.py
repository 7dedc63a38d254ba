"""AutoInt [arXiv:1810.11921] (``repro.models.recsys.autoint``): multi-head
self-attention over the field embeddings, with residual connections."""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.recsys.embeddings import ClickModel, FieldEmbedding
from repro_torch.utils import resolve_device


class AutoInt(ClickModel):
    """Parameters under the JAX names: ``fields.table``,
    ``attn_layers.<i>.{wq,wk,wv,w_res}``, ``w_out`` and ``b_out``; on
    ``device`` (default ``"cuda"``: raises without a card), drawn from
    ``generator`` with the JAX init's laws."""

    def __init__(self, cfg: RecsysConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        self.embedding = FieldEmbedding(cfg.vocab_sizes, cfg.embed_dim)
        self.fields = self.embedding.init(gen, dev)
        width = cfg.n_attn_heads * cfg.d_attn
        layers, d_in = [], cfg.embed_dim
        for _ in range(cfg.n_attn_layers):
            layers.append(nn.ParameterDict({
                name: nn.Parameter(dense_init(gen, d_in, width, device=dev))
                for name in ("wq", "wk", "wv", "w_res")}))
            d_in = width
        self.attn_layers = nn.ModuleList(layers)
        self.w_out = nn.Parameter(dense_init(gen, cfg.n_sparse * d_in, 1,
                                             device=dev))
        self.b_out = nn.Parameter(torch.zeros(1, device=dev))

    @staticmethod
    def _attn_layer(p, x: torch.Tensor, h: int, da: int) -> torch.Tensor:
        """x [B, F, D] -> [B, F, h da]: one interacting attention layer."""
        b, f, _ = x.shape
        q = (x @ p["wq"]).reshape(b, f, h, da)
        k = (x @ p["wk"]).reshape(b, f, h, da)
        v = (x @ p["wv"]).reshape(b, f, h, da)
        logits = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(da)
        w = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhfg,bghd->bfhd", w, v).reshape(b, f, h * da)
        return torch.relu(o + x @ p["w_res"])

    def _interact(self, batch: dict, use_kernel: bool,
                  split: bool = True) -> torch.Tensor:
        cfg = self.cfg
        with self._axes():
            x = self.embedding.lookup(self.fields["table"],
                                      batch["sparse_ids"], use_kernel,
                                      self.first.get("fields.table"), split)
        for p in self.attn_layers:
            x = self._attn_layer(p, x, cfg.n_attn_heads, cfg.d_attn)
        return x

    def forward(self, batch: dict, use_kernel: bool = True) -> torch.Tensor:
        """``batch["sparse_ids"]`` [B, F] or [B, F, H] -> logits [B]."""
        x = self._interact(batch, use_kernel)
        return (x.reshape(x.shape[0], -1) @ self.w_out + self.b_out)[:, 0]

    def score_candidates(self, batch: dict, candidate_ids: torch.Tensor,
                         use_kernel: bool = True) -> torch.Tensor:
        """Retrieval scores [B, C]: the mean of the user's attended fields
        dotted with each candidate's field-0 (item) embedding projected by
        the first layer's ``wv``."""
        u = self._interact(batch, use_kernel, split=False).mean(dim=1)
        table = self.fields["table"]
        with self._axes():
            cand = self.rows("fields.table", table,
                             int(self.embedding.offsets[0])
                             + candidate_ids.to(table.device).long(),
                             use_kernel=use_kernel)  # [C, D]
        c = cand @ self.attn_layers[0]["wv"] if len(self.attn_layers) \
            else cand
        return u @ c.T
