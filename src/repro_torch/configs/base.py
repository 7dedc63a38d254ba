"""The transformer configuration: the fields of ``repro.configs.base.
TransformerConfig`` that the port reads, with the same names and defaults.

The LM path reads ``sliding_window``, the compute ``dtype`` (``"float32"``
or ``"bfloat16"``; anything else raises ``ValueError``) and the chunk sizes
of the plain attention, ``attn_q_chunk`` and ``attn_kv_chunk``.  The SPLADE
encoder reads none of them, in JAX or here: it runs f32 whatever ``dtype``
says.  A knob the port does not implement is not a field, so setting it is
a ``TypeError`` rather than a silent no-op: remat, layer scan, unrolled
attention and sequence parallelism only matter for training or for XLA.
The port has no experts and keeps its parameters in f32: a config with
``moe`` set or another ``param_dtype`` raises ``NotImplementedError``.

``RecsysConfig`` copies ``repro.configs.base.RecsysConfig`` field for
field.  No recsys model reads ``dtype`` (they run f32, in JAX and here), so
any other value raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0  # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # tokens; None = full attention
    moe: Optional[object] = None
    act: str = "swiglu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # activation/compute dtype of the LM
    param_dtype: str = "float32"
    attn_q_chunk: int = 512  # tiles of the plain chunked attention
    attn_kv_chunk: int = 1024

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                f"{self.name}: mixture-of-experts layers are not ported")
        if self.param_dtype != "float32":
            raise NotImplementedError(
                f"{self.name}: param_dtype {self.param_dtype!r}; the port "
                f"keeps its parameters in float32")
        if self.dtype not in COMPUTE_DTYPES:
            raise ValueError(
                f"{self.name}: dtype {self.dtype!r}; the port computes in "
                f"{' or '.join(COMPUTE_DTYPES)}")

    @property
    def compute_dtype(self) -> torch.dtype:
        return COMPUTE_DTYPES[self.dtype]

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def num_params(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, dh = self.d_model, self.head_dim
        attn = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh) + (
            self.n_heads * dh
        ) * d
        mlp = (3 if self.act == "swiglu" else 2) * d * self.d_ff
        block = attn + mlp + 2 * d
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return embed + self.n_layers * block + head + d


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: Literal["din", "dien", "autoint", "xdeepfm"]
    n_sparse: int
    embed_dim: int
    vocab_sizes: tuple[int, ...] = ()  # per-field vocab; filled by helper
    mlp_dims: tuple[int, ...] = (200, 80)
    # DIN/DIEN
    seq_len: int = 0
    item_vocab: int = 0
    attn_mlp: tuple[int, ...] = (80, 40)
    gru_dim: int = 0
    # AutoInt
    n_attn_layers: int = 0
    n_attn_heads: int = 0
    d_attn: int = 0
    # xDeepFM
    cin_layers: tuple[int, ...] = ()
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype != "float32":
            raise NotImplementedError(
                f"{self.name}: dtype {self.dtype!r}; the recsys models run "
                f"float32")

    def total_rows(self) -> int:
        return sum(self.vocab_sizes) + (self.item_vocab or 0)
