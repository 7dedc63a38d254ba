"""gpusparse — the paper's own system as an architecture
(``repro.configs.gpusparse``, field for field).

A SPLADE-style encoder with a BERT-base-shaped backbone and the 30,522-term
vocabulary (``ENCODER_SMOKE`` is the reduced one the CPU tests run), the
device-resident inverted index and exact scoring.  The serve shapes mirror
the paper's Tables 2/4 (100K and full-8.8M MS MARCO scales, 500-query
batches, top-1000).
"""
from repro_torch.configs.base import (
    ArchSpec,
    RetrievalArchConfig,
    ShapeSpec,
    TransformerConfig,
    register,
)

ENCODER = TransformerConfig(
    name="splade-encoder",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    act="gelu",
    tie_embeddings=True,
)

ENCODER_SMOKE = TransformerConfig(
    name="splade-encoder-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    act="gelu",
    tie_embeddings=True,
    dtype="float32",
    param_dtype="float32",
    remat=False,
)

FULL = RetrievalArchConfig(
    name="gpusparse", encoder=ENCODER, vocab_size=30522, avg_doc_terms=128
)
SMOKE = RetrievalArchConfig(
    name="gpusparse-smoke", encoder=ENCODER_SMOKE, vocab_size=512,
    avg_doc_terms=32,
)

RETRIEVAL_SHAPES = (
    ShapeSpec(name="serve_100k", kind="retrieval_serve", num_docs=100_000,
              global_batch=500),
    ShapeSpec(name="serve_1m", kind="retrieval_serve", num_docs=1_000_000,
              global_batch=500),
    ShapeSpec(name="serve_8m", kind="retrieval_serve", num_docs=8_841_823,
              global_batch=500),
)

register(
    ArchSpec(
        arch_id="gpusparse",
        family="retrieval",
        config=FULL,
        shapes=RETRIEVAL_SHAPES,
        smoke_config=SMOKE,
        source="this paper",
        notes="Document-sharded exact retrieval + device-side top-k merge.",
    )
)
