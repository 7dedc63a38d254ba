"""DIN — Deep Interest Network [arXiv:1706.06978]
(``repro.models.recsys.din``).

Target attention: per-candidate weights over the user's behaviour sequence
from an MLP on [h, t, h - t, h * t], masked weighted-sum pooling, then the
prediction MLP.  ``score_candidates`` batches every candidate through the
same target attention (no per-candidate loop).

Dice takes its mean and variance over axis 0 of whatever it is given — the
batch — as the reference does: one row's logits depend on the others in
its batch, and a batch of one gives p = 0.5 everywhere.  Under a
sharding policy a forward's batch is split over every rank, and the
statistics are the whole batch's (SUM all-reduces over the mesh).
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding import ctx
from repro_torch.models.recsys.embeddings import (
    ClickModel, FieldEmbedding, apply_mlp_tower, init_mlp_tower,
)
from repro_torch.utils import resolve_device


def dice(x: torch.Tensor, eps: float = 1e-8,
         split: bool = False) -> torch.Tensor:
    """Dice activation (DIN §4.3): a PReLU gated by batch statistics (the
    population variance over axis 0).  ``split``: ``x`` is this rank's
    rows of a batch split over the whole mesh; the statistics are the
    whole batch's."""
    if split and ctx.group_size("all") > 1:
        n = x.shape[0] * ctx.group_size("all")
        mu = ctx.all_reduce_sum(x.sum(dim=0, keepdim=True), "all") / n
        var = ctx.all_reduce_sum(((x - mu) ** 2).sum(dim=0, keepdim=True),
                                 "all") / n
    else:
        mu = x.mean(dim=0, keepdim=True)
        var = x.var(dim=0, keepdim=True, correction=0)
    p = torch.sigmoid((x - mu) * torch.rsqrt(var + eps))
    return p * x + (1 - p) * 0.25 * x


class DIN(ClickModel):
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

    def _items(self, ids, split: bool = True,
               use_kernel: bool = True) -> torch.Tensor:
        return self.rows("item_table", self.item_table, ids, split,
                         use_kernel)

    def _target_attention(self, hist, mask, target,
                          split: bool = False) -> torch.Tensor:
        """hist [B, S, D], mask [B, S], target [B, C, D] -> [B, C, D]."""
        b, s, d = hist.shape
        c = target.shape[1]
        h_b = hist[:, None, :, :].expand(b, c, s, d)
        t_b = target[:, :, None, :].expand(b, c, s, d)
        feats = torch.cat([h_b, t_b, h_b - t_b, h_b * t_b], dim=-1)
        act = functools.partial(dice, split=split)
        w = apply_mlp_tower(self.attn, feats, act=act)[..., 0]  # [B, C, S]
        w = w + (mask[:, None, :] - 1.0) * 1e9
        # un-normalised weights, as the paper: no softmax, pads masked to 0
        w = torch.where(mask[:, None, :] > 0, w, 0.0)
        return torch.einsum("bcs,bsd->bcd", w, hist)

    def _logits(self, batch: dict, target_emb: torch.Tensor,
                use_kernel: bool, split: bool = True) -> torch.Tensor:
        """target_emb [B, C, D] -> logits [B, C]."""
        hist = self._items(batch["hist_ids"], split, use_kernel)
        mask = batch["hist_mask"].to(hist.device)
        pooled = self._target_attention(hist, mask, target_emb, split)
        ctx = self.embedding.lookup(self.fields["table"],
                                    batch["sparse_ids"], use_kernel,
                                    self.first.get("fields.table"), split)
        b, c, _ = pooled.shape
        ctx_b = ctx.reshape(b, 1, -1).expand(b, c, -1)
        x = torch.cat([pooled, target_emb, ctx_b], dim=-1)
        return apply_mlp_tower(self.mlp, x, act=functools.partial(
            dice, split=split))[..., 0]

    def forward(self, batch: dict, use_kernel: bool = True) -> torch.Tensor:
        """A click batch -> logits [B]."""
        with self._axes():
            target = self._items(batch["target_id"], use_kernel=use_kernel)
            return self._logits(batch, target[:, None, :], use_kernel)[:, 0]

    def score_candidates(self, batch: dict, candidate_ids: torch.Tensor,
                         use_kernel: bool = True) -> torch.Tensor:
        """[B, C] scores, every candidate through the target attention."""
        with self._axes():
            cand = self._items(candidate_ids, use_kernel=use_kernel)
            b = batch["hist_ids"].shape[0]
            cand_b = cand[None].expand(b, *cand.shape)
            return self._logits(batch, cand_b, use_kernel, split=False)
