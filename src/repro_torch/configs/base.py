"""Config system: typed dataclasses and the architecture/shape registry
(``repro.configs.base``).

``TransformerConfig`` holds the fields of ``repro.configs.base.
TransformerConfig`` that the port reads, with the same names and defaults.
The LM path reads ``sliding_window``, ``moe`` (a :class:`MoEConfig`:
mixture-of-experts layers in place of the MLP), the compute ``dtype``
(``"float32"`` or ``"bfloat16"``; anything else raises ``ValueError``),
the chunk sizes of the plain attention, ``attn_q_chunk`` and
``attn_kv_chunk``, in training ``remat`` (each block's activations
recomputed in the backward, as ``jax.checkpoint`` does), and, under a
sharding policy with a model axis, ``seq_parallel`` (Megatron's sequence
parallelism: the residual stream between blocks split over the model axis
on the sequence dim, JAX's ``constrain(x, "batch", "tp", None)``; the
numbers are unchanged).  The SPLADE encoder reads none of them, in JAX or
here: it runs f32 whatever ``dtype`` says.  A knob the port does not
implement is not a field, so setting it is a ``TypeError`` rather than a
silent no-op.  JAX's ``scan_layers`` and ``attn_unroll`` are XLA lowering
knobs (a ``lax.scan`` over stacked layers, Python-unrolled attention
chunks for the cost probes): the port's blocks are a Python loop, which
is ``scan_layers=False``'s semantics, and its chunk loops are Python
already, so neither is a field.  The port keeps its parameters in f32:
another ``param_dtype`` raises ``NotImplementedError``.

``MoEConfig``, ``SchNetConfig``, ``RecsysConfig``, ``RetrievalArchConfig``,
``ShapeSpec`` and ``ArchSpec`` copy the JAX dataclasses field for field.
No recsys model or SchNet reads ``dtype`` (they run f32, in JAX and here),
so any other value raises ``NotImplementedError``.

Every architecture the port runs registers an :class:`ArchSpec` (its
config, shape grid, smoke config and source) when its module under
``repro_torch.configs`` is imported; :func:`get_arch` and
:func:`list_archs` import them all first.  The registry is JAX's, every
architecture included.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Literal, Optional

import torch

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MOE_DISPATCHES = ("einsum", "ragged")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    aux_loss_weight: float = 0.01
    capacity_factor: float = 1.25
    # "einsum": GShard dispatch with per-group capacity (tokens past it are
    # dropped); "ragged": dropless, each expert's rows contiguous after a
    # stable sort (``repro_torch.models.layers.moe_einsum``/``moe_ragged``).
    dispatch: str = "einsum"
    # tokens per dispatch group (the capacity is counted per group)
    group_tokens: int = 2048

    def __post_init__(self):
        if self.dispatch not in MOE_DISPATCHES:
            raise ValueError(f"dispatch {self.dispatch!r}; one of "
                             f"{MOE_DISPATCHES}")


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
    moe: Optional[MoEConfig] = None
    act: str = "swiglu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"  # activation/compute dtype of the LM
    param_dtype: str = "float32"
    remat: bool = True  # recompute each LM block in the backward
    # under a policy with a model axis: the residual stream between blocks
    # split over the model axis on the sequence dim (training and prefill)
    seq_parallel: bool = False
    attn_q_chunk: int = 512  # tiles of the plain chunked attention
    attn_kv_chunk: int = 1024

    def __post_init__(self):
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
        mlp_dense = (3 if self.act == "swiglu" else 2) * d * self.d_ff
        if self.moe:
            mlp = self.moe.num_experts * mlp_dense + d * self.moe.num_experts
        else:
            mlp = mlp_dense
        block = attn + mlp + 2 * d
        embed = self.vocab_size * d
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return embed + self.n_layers * block + head + d

    def num_active_params(self) -> int:
        """Active (per-token) params: MoE counts only routed experts."""
        if not self.moe:
            return self.num_params()
        d = self.d_model
        mlp_dense = (3 if self.act == "swiglu" else 2) * d * self.d_ff
        inactive = (self.moe.num_experts - self.moe.top_k) * mlp_dense
        return self.num_params() - self.n_layers * inactive


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    d_in: int = 0  # input node-feature dim (0 = atomic-number embedding)
    n_out: int = 1
    dtype: str = "float32"

    def __post_init__(self):
        if self.dtype != "float32":
            raise NotImplementedError(
                f"{self.name}: dtype {self.dtype!r}; SchNet runs float32")


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


@dataclasses.dataclass(frozen=True)
class RetrievalArchConfig:
    """The paper's own system as an arch: SPLADE encoder + sparse index."""

    name: str
    encoder: TransformerConfig
    vocab_size: int = 30522
    avg_doc_terms: int = 128
    engine: str = "tiled"


# ---------------------------------------------------------------------------
# Shapes and the registry


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Literal[
        "train",  # LM training step
        "prefill",  # LM inference prefill
        "decode",  # LM decode w/ KV cache
        "long_decode",  # LM decode, 500k context (sub-quadratic only)
        "gnn_full",  # full-graph train step
        "gnn_minibatch",  # sampled-subgraph train step
        "gnn_batched",  # batched small graphs
        "recsys_train",
        "recsys_serve",
        "recsys_retrieval",
        "retrieval_serve",  # the paper's serving step
    ]
    seq_len: int = 0
    global_batch: int = 0
    # GNN extras
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: tuple[int, ...] = ()
    # recsys extras
    n_candidates: int = 0
    # retrieval extras
    num_docs: int = 0


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: Literal["lm", "gnn", "recsys", "retrieval"]
    config: Any
    shapes: tuple[ShapeSpec, ...]
    smoke_config: Any
    source: str = ""
    skip_shapes: tuple[str, ...] = ()  # documented skips
    notes: str = ""


_REGISTRY: dict[str, ArchSpec] = {}

# The config modules that register an arch (JAX's).
ARCH_MODULES = (
    "qwen3_4b",
    "smollm_135m",
    "qwen2_0_5b",
    "mixtral_8x22b",
    "olmoe_1b_7b",
    "schnet",
    "dien",
    "autoint",
    "din",
    "xdeepfm",
    "gpusparse",
)


def register(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch {spec.arch_id}")
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; registered: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    """Import all config modules (they self-register)."""
    import importlib

    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


# Shared LM shape grid.
LM_SHAPES = (
    ShapeSpec(name="train_4k", kind="train", seq_len=4096, global_batch=256),
    ShapeSpec(name="prefill_32k", kind="prefill", seq_len=32768,
              global_batch=32),
    ShapeSpec(name="decode_32k", kind="decode", seq_len=32768,
              global_batch=128),
    ShapeSpec(name="long_500k", kind="long_decode", seq_len=524288,
              global_batch=1),
)

GNN_SHAPES = (
    ShapeSpec(name="full_graph_sm", kind="gnn_full", n_nodes=2708,
              n_edges=10556, d_feat=1433),
    ShapeSpec(name="minibatch_lg", kind="gnn_minibatch", n_nodes=232965,
              n_edges=114615892, batch_nodes=1024, fanout=(15, 10)),
    ShapeSpec(name="ogb_products", kind="gnn_full", n_nodes=2449029,
              n_edges=61859140, d_feat=100),
    ShapeSpec(name="molecule", kind="gnn_batched", n_nodes=30, n_edges=64,
              global_batch=128),
)

RECSYS_SHAPES = (
    ShapeSpec(name="train_batch", kind="recsys_train", global_batch=65536),
    ShapeSpec(name="serve_p99", kind="recsys_serve", global_batch=512),
    ShapeSpec(name="serve_bulk", kind="recsys_serve", global_batch=262144),
    ShapeSpec(name="retrieval_cand", kind="recsys_retrieval", global_batch=1,
              n_candidates=1_000_000),
)
