"""DIN — Deep Interest Network [arXiv:1706.06978]
(``repro.models.recsys.din``).

Target attention: per-candidate weights over the user's behaviour sequence
from an MLP on [h, t, h - t, h * t], masked weighted-sum pooling, then the
prediction MLP.  ``score_candidates`` batches every candidate through the
same target attention (no per-candidate loop).

Dice takes its mean and variance over axis 0 of whatever it is given — the
batch — as the reference does: one row's logits depend on the others in
its batch, and a batch of one gives p = 0.5 everywhere.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.recsys.embeddings import (
    FieldEmbedding, apply_mlp_tower, init_mlp_tower,
)
from repro_torch.utils import resolve_device


def dice(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Dice activation (DIN §4.3): a PReLU gated by batch statistics (the
    population variance over axis 0)."""
    mu = x.mean(dim=0, keepdim=True)
    var = x.var(dim=0, keepdim=True, correction=0)
    p = torch.sigmoid((x - mu) * torch.rsqrt(var + eps))
    return p * x + (1 - p) * 0.25 * x


class DIN(nn.Module):
    """Parameters under the JAX names: ``fields.table``, ``item_table``,
    ``attn.*`` and ``mlp.*``; on ``device`` (default ``"cuda"``: raises
    without a card), drawn from ``generator`` with the JAX init's laws."""

    def __init__(self, cfg: RecsysConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        d = cfg.embed_dim
        self.embedding = FieldEmbedding(cfg.vocab_sizes, d)
        self.fields = self.embedding.init(gen, dev)
        self.item_table = nn.Parameter(dense_init(gen, cfg.item_vocab, d,
                                                  device=dev))
        self.attn = init_mlp_tower(gen, (4 * d, *cfg.attn_mlp), 1,
                                   device=dev)
        mlp_in = d + d + len(cfg.vocab_sizes) * d  # pooled, target, context
        self.mlp = init_mlp_tower(gen, (mlp_in, *cfg.mlp_dims), 1,
                                  device=dev)

    def _items(self, ids) -> torch.Tensor:
        return self.item_table[ids.to(self.item_table.device).long()]

    def _target_attention(self, hist, mask, target) -> torch.Tensor:
        """hist [B, S, D], mask [B, S], target [B, C, D] -> [B, C, D]."""
        b, s, d = hist.shape
        c = target.shape[1]
        h_b = hist[:, None, :, :].expand(b, c, s, d)
        t_b = target[:, :, None, :].expand(b, c, s, d)
        feats = torch.cat([h_b, t_b, h_b - t_b, h_b * t_b], dim=-1)
        w = apply_mlp_tower(self.attn, feats, act=dice)[..., 0]  # [B, C, S]
        w = w + (mask[:, None, :] - 1.0) * 1e9
        # un-normalised weights, as the paper: no softmax, pads masked to 0
        w = torch.where(mask[:, None, :] > 0, w, 0.0)
        return torch.einsum("bcs,bsd->bcd", w, hist)

    def _logits(self, batch: dict, target_emb: torch.Tensor,
                use_kernel: bool) -> torch.Tensor:
        """target_emb [B, C, D] -> logits [B, C]."""
        hist = self._items(batch["hist_ids"])
        mask = batch["hist_mask"].to(hist.device)
        pooled = self._target_attention(hist, mask, target_emb)  # [B, C, D]
        ctx = self.embedding.lookup(self.fields["table"],
                                    batch["sparse_ids"], use_kernel)
        b, c, _ = pooled.shape
        ctx_b = ctx.reshape(b, 1, -1).expand(b, c, -1)
        x = torch.cat([pooled, target_emb, ctx_b], dim=-1)
        return apply_mlp_tower(self.mlp, x, act=dice)[..., 0]

    def forward(self, batch: dict, use_kernel: bool = True) -> torch.Tensor:
        """A click batch -> logits [B]."""
        target = self._items(batch["target_id"])
        return self._logits(batch, target[:, None, :], use_kernel)[:, 0]

    def score_candidates(self, batch: dict, candidate_ids: torch.Tensor,
                         use_kernel: bool = True) -> torch.Tensor:
        """[B, C] scores, every candidate through the target attention."""
        cand = self._items(candidate_ids)  # [C, D]
        b = batch["hist_ids"].shape[0]
        cand_b = cand[None].expand(b, *cand.shape)
        return self._logits(batch, cand_b, use_kernel)
