"""DIEN — Deep Interest Evolution Network [arXiv:1809.03672]
(``repro.models.recsys.dien``).

Interest extraction: a GRU over the behaviour sequence; interest
evolution: an AUGRU (the update gate scaled by attention) conditioned on
the target item.  Both recurrences are a Python loop over the sequence
(JAX's ``lax.scan``).  The GRU is the reference's, not ``torch.nn.GRU``:
its update is (1 - z) h + z n, ``b`` is added to the input half only, and
the gates split in r, z, n order.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.layers import dense_init
from repro_torch.models.recsys.embeddings import (
    ClickModel, FieldEmbedding, apply_mlp_tower, init_mlp_tower,
)
from repro_torch.utils import resolve_device


def init_gru(gen: torch.Generator, d_in: int, d_h: int,
             device) -> nn.ParameterDict:
    return nn.ParameterDict({
        "w": nn.Parameter(dense_init(gen, d_in, 3 * d_h, device=device)),
        "u": nn.Parameter(dense_init(gen, d_h, 3 * d_h, device=device)),
        "b": nn.Parameter(torch.zeros(3 * d_h, device=device)),
    })


def gru_cell(p, h: torch.Tensor, x: torch.Tensor,
             attn: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One GRU step; ``attn``, a scalar per row, makes it an AUGRU."""
    xr, xz, xn = (x @ p["w"] + p["b"]).chunk(3, dim=-1)
    hr, hz, hn = (h @ p["u"]).chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    if attn is not None:
        z = z * attn[:, None]  # AUGRU: attention scales the update gate
    return (1 - z) * h + z * n


def run_gru(p, xs: torch.Tensor, mask: torch.Tensor,
            attn: Optional[torch.Tensor] = None):
    """xs [B, S, D_in], mask [B, S] -> (the last hidden state [B, D_h],
    every state [B, S, D_h]); a step of mask 0 keeps h."""
    b, s, _ = xs.shape
    h = xs.new_zeros((b, p["u"].shape[0]))
    states = []
    for t in range(s):
        h_new = gru_cell(p, h, xs[:, t], None if attn is None
                         else attn[:, t])
        h = torch.where(mask[:, t, None] > 0, h_new, h)
        states.append(h)
    return h, torch.stack(states, dim=1)


class DIEN(ClickModel):
    """Parameters under the JAX names: ``fields.table``, ``item_table``,
    ``gru1.{w,u,b}``, ``gru2.{w,u,b}``, ``attn_proj`` and ``mlp.*``; on
    ``device`` (default ``"cuda"``: raises without a card), drawn from
    ``generator`` with the JAX init's laws."""

    def __init__(self, cfg: RecsysConfig, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator()
        self.cfg = cfg
        d, g = cfg.embed_dim, cfg.gru_dim
        self.embedding = FieldEmbedding(cfg.vocab_sizes, d)
        self.fields = self.embedding.init(gen, dev)
        self.item_table = nn.Parameter(dense_init(gen, cfg.item_vocab, d,
                                                  device=dev))
        self.gru1 = init_gru(gen, d, g, dev)
        self.gru2 = init_gru(gen, g, g, dev)
        self.attn_proj = nn.Parameter(dense_init(gen, d, g, device=dev))
        mlp_in = g + d + len(cfg.vocab_sizes) * d
        self.mlp = init_mlp_tower(gen, (mlp_in, *cfg.mlp_dims), 1,
                                  device=dev)

    def _items(self, ids, split: bool = True,
               use_kernel: bool = True) -> torch.Tensor:
        return self.rows("item_table", self.item_table, ids, split,
                         use_kernel)

    def _extract(self, batch: dict, split: bool = True,
                 use_kernel: bool = True) -> torch.Tensor:
        """Interest extraction over the behaviour history -> [B, S, G]."""
        hist = self._items(batch["hist_ids"], split, use_kernel)
        mask = batch["hist_mask"].to(hist.device)
        return run_gru(self.gru1, hist, mask)[1]

    def _evolve(self, states, mask, target_emb) -> torch.Tensor:
        """AUGRU interest evolution conditioned on the target -> [B, G]."""
        t_proj = target_emb @ self.attn_proj  # [B, G]
        scores = torch.einsum("bsg,bg->bs", states, t_proj)
        scores = torch.where(mask > 0, scores, -1e9)
        attn = torch.softmax(scores, dim=-1) * mask
        return run_gru(self.gru2, states, mask, attn=attn)[0]

    def forward(self, batch: dict, use_kernel: bool = True) -> torch.Tensor:
        """A click batch -> logits [B]."""
        with self._axes():
            target = self._items(batch["target_id"], use_kernel=use_kernel)
            mask = batch["hist_mask"].to(target.device)
            interest = self._evolve(self._extract(batch, True, use_kernel),
                                    mask, target)
            ctx = self.embedding.lookup(self.fields["table"],
                                        batch["sparse_ids"], use_kernel,
                                        self.first.get("fields.table"))
        x = torch.cat([interest, target, ctx.reshape(ctx.shape[0], -1)],
                      dim=-1)
        return apply_mlp_tower(self.mlp, x)[:, 0]

    def user_vector(self, batch: dict, split: bool = True,
                    use_kernel: bool = True) -> torch.Tensor:
        """The target-free user interest [B, G] (uniform attention through
        the AUGRU): the two-tower serving head of retrieval."""
        with self._axes():
            states = self._extract(batch, split, use_kernel)
        mask = batch["hist_mask"].to(states.device)
        attn = mask / torch.clamp_min(mask.sum(dim=-1, keepdim=True), 1.0)
        return run_gru(self.gru2, states, mask, attn=attn)[0]

    def score_candidates(self, batch: dict, candidate_ids: torch.Tensor,
                         use_kernel: bool = True) -> torch.Tensor:
        """[B, C] batched-dot retrieval scores (no per-candidate loop).
        The user vector reads no field embedding: ``use_kernel`` reaches
        the kernel only through a row-sharded ``item_table``."""
        with self._axes():
            cand = self._items(candidate_ids, use_kernel=use_kernel)
        u = self.user_vector(batch, False, use_kernel)  # [B, G]
        return u @ (cand @ self.attn_proj).T
