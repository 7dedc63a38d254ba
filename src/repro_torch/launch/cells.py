"""Cell factory: (architecture x shape x layout) -> step + inputs + model
FLOPs (``repro.launch.cells``).

Each cell is the contract for one dry-run count: the port's own step
function (``make_train_step``, or ``make_sharded_train_step`` under the
layout's policy, with the microbatch count, a model's serve call, the
recsys retrieval step, the sharded ``ell`` serve step), its inputs, and
metadata (analytic model FLOPs, microbatching, notes).  By default the parameters, optimizer state
and inputs are ``meta`` tensors of the step's shapes: nothing is
allocated, and :mod:`repro_torch.analysis.probes` counts the step's
operations, bytes and live memory by running it there.  With
``device="cuda"`` the same cell holds seeded weights and inputs on the
card (``launch.dryrun --device cuda`` times it); a GNN cell's inputs are
then :func:`gnn_batch`'s graphs.

Layouts (:mod:`repro_torch.launch.mesh`): ``"single"`` (one H100),
``"quad"`` (four, data 4 x model 1) and ``"quad_tp"`` (four as data 2 x
model 2).  A cell's inputs are one rank's: an LM batch's leading dim
divided by the data-parallel ranks, a recsys or molecule batch's by every
rank, a single graph's (``gnn_full``, ``gnn_minibatch``) edges by every
rank with its nodes whole, as JAX shards them; a one-user retrieval
replicated, a document index cut into one shard a rank.  On more than
one card every training cell steps under the layout's sharding policy
(:func:`train_policy`; ``make_sharded_train_step``): LM parameters and
moments by ``lm_param_specs`` (FSDP over data, TP or EP over model),
with JAX's ``adjusted_lm_cfg`` decision (:func:`seq_parallel`) put into
the config's ``seq_parallel``; recsys tables row-sharded by
``recsys_param_specs`` for training; SchNet replicated, its edges or
molecules split.  At ``"quad_tp"`` the serving cells run under the
layout's policy too (:func:`cell_policy`: LM parameters and KV caches by
``lm_param_specs``/``lm_cache_specs``, recsys tables by
``recsys_param_specs`` for serving).  Either way a cell's tensors are
one rank's shards and its step the sharded path.  ``model_flops`` is the
global useful work, JAX's formulas copied, on JAX's padded sizes.

On ``meta`` the cells run the plain path, since kernel entries raise
there (``use_kernel=False``; the ``ell`` step scores through
``ell_gather_ref``); on a card they run the program's own path, the
hand-written kernels included.  Branches that read values (the LM's token range
check, the top-k's tie repair) are not taken on ``meta``, which holds
none; the MoE layers dispatch by ``"einsum"``, JAX's default, which reads
nothing back.  A cell that cannot run on ``meta`` raises with its name.
The LM training cells record the sequence-parallel decision in ``meta``
as well.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import (
    ArchSpec, RecsysConfig, SchNetConfig, ShapeSpec, TransformerConfig,
    get_arch, list_archs,
)
from repro_torch.launch.mesh import Layout, make_device_mesh, production_layout
from repro_torch.sharding import policies as pol
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import (
    init_state, make_sharded_train_step, make_train_step,
)
from repro_torch.utils import cdiv, ceil_to, resolve_device

# Activation-memory budget per device for checkpointed layer inputs
# (bytes); drives the microbatch count for LM training cells (JAX's).
ACT_BUDGET = 1_500_000_000
RETRIEVAL_K = 1000  # the gpusparse serve cells' top-k
CANDIDATE_K = 100  # the recsys retrieval cells' top-k
MOLECULE_D_IN = 16  # gnn_batched's atom features


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    layout: str
    step_fn: Callable
    args: tuple  # one rank's inputs (meta tensors by default)
    model_flops: float  # analytic useful FLOPs per step (global)
    meta: dict
    model: Optional[torch.nn.Module] = None  # whose step it is, if any


# ---------------------------------------------------------------------------
# Inputs: meta tensors, or seeded ones on a device


@dataclasses.dataclass(frozen=True)
class Input:
    """One input of a step: its shape, dtype and the law of its values
    (``("int", high)`` uniform on [0, high), ``("normal",)``,
    ``("uniform", lo, hi)``, ``("ones",)``, ``("bernoulli",)``)."""

    shape: tuple
    dtype: torch.dtype
    law: tuple = ("normal",)


def _materialize(specs: dict, device: torch.device, gen) -> dict:
    out = {}
    for name, s in specs.items():
        if device.type == "meta":
            out[name] = torch.empty(s.shape, dtype=s.dtype, device=device)
            continue
        kind = s.law[0]
        if kind == "int":
            t = torch.randint(0, s.law[1], s.shape, generator=gen,
                              device=device, dtype=torch.int64)
        elif kind == "uniform":
            t = torch.rand(s.shape, generator=gen, device=device)
            t = s.law[1] + (s.law[2] - s.law[1]) * t
        elif kind == "ones":
            t = torch.ones(s.shape, device=device)
        elif kind == "bernoulli":
            t = (torch.rand(s.shape, generator=gen, device=device)
                 < 0.5).float()
        else:
            t = torch.randn(s.shape, generator=gen, device=device)
        out[name] = t.to(s.dtype)
    return out


def _generator(device: torch.device, seed: int):
    if device.type == "meta":
        return None  # nothing is drawn on meta
    return torch.Generator(device=device).manual_seed(seed)


def _policy(spec: ArchSpec, layout: Layout, device):
    """The layout's sharding policy: over its ``AbstractMesh`` on
    ``meta`` (a step counted as rank 0's), else over the process group's
    ranks (raises without one of the layout's size); expert parallelism
    as ``layout.expert_parallel`` says, by default
    ``default_expert_parallel``."""
    ep = layout.expert_parallel
    if ep is None:
        ep = pol.default_expert_parallel(spec.config, layout.tp)
    mesh = (layout.abstract_mesh() if device.type == "meta"
            else make_device_mesh(layout, device.type))
    return pol.make_policy(mesh, expert_parallel=ep)


def cell_policy(spec: ArchSpec, layout: Layout, device):
    """The policy a serving cell runs under: the layout's (:func:`_policy`)
    where it has a model axis, else None."""
    return None if layout.tp == 1 else _policy(spec, layout, device)


def train_policy(spec: ArchSpec, layout: Layout, device):
    """The policy a training cell steps under: the layout's on more than
    one card (``"quad"`` too: FSDP over its data axis of 4), else None."""
    return None if layout.cards == 1 else _policy(spec, layout, device)


def _policy_meta(policy, model) -> dict:
    """What ``meta`` records of a cell's policy: the mesh, expert
    parallelism and one rank's parameter bytes (its shards')."""
    return {"mesh": tuple(policy.mesh.shape),
            "expert_parallel": policy.expert_parallel,
            "param_bytes_per_rank": sum(4 * p.numel()
                                        for p in model.parameters())}


def _local(n: int, layout: Layout) -> int:
    """One rank's rows of a leading dim of ``n`` (replicated when the
    ranks do not divide it, as JAX replicates it)."""
    return n // layout.dp if n % layout.dp == 0 else n


def _train_step(loss_fn, plan: Optional[pol.TrainPlan],
                microbatches: int = 1):
    """``make_train_step``, or under a plan ``make_sharded_train_step``."""
    adamw = AdamWConfig()
    if plan is None:
        return make_train_step(loss_fn, adamw, microbatches=microbatches)
    return make_sharded_train_step(loss_fn, adamw, plan, microbatches)


def _train_args(model, batch: dict) -> tuple:
    state = init_state(dict(model.named_parameters()), AdamWConfig())
    return (state.as_dict(), batch)


def _no_grad(fn):
    def step(*args):
        with torch.no_grad():
            return fn(*args)
    return step


# ---------------------------------------------------------------------------
# LM cells


def _lm_microbatches(cfg: TransformerConfig, shape: ShapeSpec, dp: int) -> int:
    """Largest microbatch count that keeps per-device checkpointed layer
    inputs under ACT_BUDGET while the per-microbatch batch still shards
    evenly over dp (B_mb % dp == 0 — losing the batch shard is far worse
    than a bigger activation footprint)."""
    tokens_per_dev = shape.global_batch * shape.seq_len // dp
    bytes_all = cfg.n_layers * tokens_per_dev * cfg.d_model * 2
    want = max(1, cdiv(bytes_all, ACT_BUDGET))
    # admissible mb values: global_batch % mb == 0 and (gb // mb) % dp == 0
    options = [
        m for m in range(1, shape.global_batch + 1)
        if shape.global_batch % m == 0 and (shape.global_batch // m) % dp == 0
    ]
    if not options:
        return 1
    at_least = [m for m in options if m >= want]
    return min(at_least) if at_least else max(options)


def _lm_model_flops(cfg: TransformerConfig, shape: ShapeSpec) -> float:
    n_active = cfg.num_active_params()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        base = 6.0 * n_active * tokens
        ctx = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        attn = 12.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * tokens * ctx / 2
        return base + attn
    if shape.kind == "prefill":
        ctx = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
        return (
            2.0 * n_active * tokens
            + 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * tokens * ctx / 2
        )
    # decode: one token per sequence
    cache = min(shape.seq_len, cfg.sliding_window or shape.seq_len)
    return (
        2.0 * n_active * shape.global_batch
        + 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim
        * shape.global_batch * cache
    )


def seq_parallel(cfg: TransformerConfig, shape: ShapeSpec,
                 layout: Layout) -> bool:
    """JAX's ``adjusted_lm_cfg`` decision: sequence parallelism for a
    training cell whose per-device remat residuals (n_layers x seq x
    d_model x 2 B at the minimum microbatch) exceed ACT_BUDGET, when the
    model axis divides the sequence."""
    if shape.kind != "train":
        return False
    resid = cfg.n_layers * shape.seq_len * cfg.d_model * 2
    return resid > ACT_BUDGET and shape.seq_len % layout.tp == 0


def _lm_cell(spec: ArchSpec, shape: ShapeSpec, layout: Layout, device,
             seed: int, microbatches: Optional[int] = None,
             seq_parallel_on: Optional[bool] = None) -> Cell:
    from repro_torch.models.transformer import TransformerLM

    cfg: TransformerConfig = spec.config
    train = shape.kind == "train"
    if train:
        sp = (seq_parallel(cfg, shape, layout) if seq_parallel_on is None
              else seq_parallel_on)
        cfg = dataclasses.replace(cfg, seq_parallel=sp)
    policy = (train_policy if train else cell_policy)(spec, layout, device)
    model = TransformerLM(cfg, device=device,
                          generator=_generator(device, seed), policy=policy)
    gen = _generator(device, seed + 1)
    meta = {"kind": shape.kind, "compute": _lm_compute(cfg)}
    if policy is not None:
        meta["policy"] = _policy_meta(policy, model)
    flops = _lm_model_flops(cfg, shape)
    kernels = device.type != "meta"
    if train:
        mb = (microbatches if microbatches is not None
              else _lm_microbatches(cfg, shape, layout.dp))
        b = shape.global_batch // layout.dp
        s = shape.seq_len
        tok = Input((b, s), torch.int32, ("int", cfg.vocab_size))
        batch = _materialize({"tokens": tok, "targets": tok,
                              "loss_mask": Input((b, s), torch.float32,
                                                 ("ones",))}, device, gen)
        meta.update(microbatches=mb, seq_parallel=cfg.seq_parallel)
        return Cell(spec.arch_id, shape.name, layout.name,
                    _train_step(model.loss_fn, policy and model.train_plan(),
                                mb),
                    _train_args(model, batch), flops, meta, model)
    if shape.kind == "prefill":
        b = _local(shape.global_batch, layout)
        tokens = _materialize({"tokens": Input(
            (b, shape.seq_len), torch.int32, ("int", cfg.vocab_size))},
            device, gen)["tokens"]

        def prefill(params, tokens):
            return model.prefill(tokens, use_kernel=kernels)

        return Cell(spec.arch_id, shape.name, layout.name, _no_grad(prefill),
                    (dict(model.named_parameters()), tokens), flops, meta,
                    model)
    # decode / long_decode: one token per sequence at the cache's end;
    # under a policy the cache is the rank's block of the global one and
    # the tokens its rows where the cache splits the batch
    if policy is None:
        b = _local(shape.global_batch, layout)
        cache = model.init_cache(b, shape.seq_len)
    else:
        cache = model.init_cache(shape.global_batch, shape.seq_len)
        b = shape.global_batch // model.cache_data
    tokens = _materialize({"tokens": Input((b,), torch.int32,
                                           ("int", cfg.vocab_size))},
                          device, gen)["tokens"]
    position = shape.seq_len - 1

    def serve_step(params, cache, tokens):
        return model.decode_step(cache, tokens, position)

    meta["cache_len"] = model.cache_len(shape.seq_len)
    return Cell(spec.arch_id, shape.name, layout.name, _no_grad(serve_step),
                (dict(model.named_parameters()), cache, tokens), flops, meta,
                model)


def _lm_compute(cfg: TransformerConfig) -> str:
    return "bf16" if cfg.dtype == "bfloat16" else "f32"


# ---------------------------------------------------------------------------
# GNN cells


def _gnn_model_flops(cfg: SchNetConfig, n_nodes: int, n_edges: int,
                     d_feat: int, train: bool = True) -> float:
    d, r = cfg.d_hidden, cfg.n_rbf
    per_edge = 2 * (r * d + d * d) + 4 * d  # filter MLP + message
    per_node = 2 * 4 * d * d  # in/out projections
    fwd = cfg.n_interactions * (n_edges * per_edge + n_nodes * per_node)
    fwd += n_nodes * 2 * d_feat * d  # input embed
    return fwd * (3.0 if train else 1.0)


def gnn_sizes(shape: ShapeSpec) -> tuple[int, int, int]:
    """(nodes, edges, d_feat) of a full-graph or sampled-subgraph cell:
    ``minibatch_lg`` pads the subgraph to every sampled slot (fanout 15,
    10 from 1,024 seeds) with Reddit's 602 features."""
    if shape.kind == "gnn_minibatch":
        seeds = shape.batch_nodes
        f1, f2 = shape.fanout
        return (seeds * (1 + f1 + f1 * f2), seeds * f1 + seeds * f1 * f2,
                602)
    return shape.n_nodes, shape.n_edges, shape.d_feat


def gnn_batch(shape: ShapeSpec, seed: int, n_dev: int = 1,
              cutoff: float = 10.0) -> tuple[dict, dict]:
    """The seeded numpy batch of a GNN cell, and what was sampled: a
    single graph whole (its edges padded to split over ``n_dev`` ranks;
    the cell cuts each rank's share), one rank's molecules.

    ``gnn_full``: :func:`make_graph`'s graph, a standard normal target a
    node and half the nodes in the loss.  ``gnn_minibatch``: a CSR of the
    shape's nodes and edges made without a sort (multinomial degrees ->
    ``indptr``, uniform ``indices``), :func:`sample_neighbors` from
    ``batch_nodes`` distinct seeds at the shape's fanout, padded to
    :func:`gnn_sizes` (padded nodes: zero features, out of the loss), the
    loss on the seeds alone.  ``gnn_batched``: one rank's molecules, ids
    uniform within each.  Padded edges have sender 0 and receiver N, which
    the model drops; distances are uniform on [0.5, ``cutoff``)."""
    import numpy as np

    from repro_torch.data.synthetic import make_graph, sample_neighbors

    rng = np.random.default_rng(seed)
    if shape.kind == "gnn_batched":
        b = ceil_to(shape.global_batch, n_dev) // n_dev
        n, e = shape.n_nodes, shape.n_edges
        return {
            "node_feat": rng.standard_normal((b, n, MOLECULE_D_IN),
                                             dtype=np.float32),
            "senders": rng.integers(0, n, size=(b, e), dtype=np.int32),
            "receivers": rng.integers(0, n, size=(b, e), dtype=np.int32),
            "distances": rng.uniform(0.5, cutoff, size=(b, e)).astype(
                np.float32),
            "energy": rng.standard_normal(b, dtype=np.float32),
        }, {}
    n_pad, n_edges, d_feat = gnn_sizes(shape)
    e_pad = ceil_to(n_edges, n_dev)
    if shape.kind == "gnn_full":
        g = make_graph(n_pad, n_edges, d_feat, seed=seed, cutoff=cutoff)
        g["targets"] = rng.standard_normal(n_pad, dtype=np.float32)
        g["node_mask"] = (rng.random(n_pad) < 0.5).astype(np.float32)
        m, info = n_edges, {}
    else:
        n, e = shape.n_nodes, shape.n_edges
        deg = rng.multinomial(e, np.full(n, 1.0 / n))
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(deg, out=indptr[1:])
        del deg
        indices = rng.integers(0, n, size=e, dtype=np.int32)
        seeds = rng.choice(n, size=shape.batch_nodes, replace=False)
        sub = sample_neighbors(indptr, indices, seeds, list(shape.fanout),
                               rng)
        del indptr, indices
        n_s, m = len(sub["node_ids"]), len(sub["senders"])
        if n_s > n_pad or m > e_pad:
            raise AssertionError(f"sampled {n_s} nodes, {m} edges: more "
                                 f"than the cell's {n_pad}, {e_pad}")
        feat = np.zeros((n_pad, d_feat), dtype=np.float32)
        feat[:n_s] = rng.standard_normal((n_s, d_feat), dtype=np.float32)
        mask = np.zeros(n_pad, dtype=np.float32)
        mask[sub["seed_local"]] = 1.0
        g = {"node_feat": feat, "senders": sub["senders"],
             "receivers": sub["receivers"],
             "distances": rng.uniform(0.5, cutoff, size=m).astype(
                 np.float32),
             "node_mask": mask,
             "targets": rng.standard_normal(n_pad, dtype=np.float32)}
        info = {"graph_nodes": n, "graph_edges": e, "seeds": len(seeds),
                "sampled_nodes": n_s, "sampled_edges": m}
    if e_pad > m:
        fill = {"senders": 0, "receivers": n_pad, "distances": 1.0}
        for k, v in fill.items():
            g[k] = np.concatenate([g[k], np.full(e_pad - m, v,
                                                 dtype=g[k].dtype)])
    return g, info


def _gnn_cell(spec: ArchSpec, shape: ShapeSpec, layout: Layout, device,
              seed: int) -> Cell:
    """On ``meta`` the batch's shapes alone; on a device :func:`gnn_batch`
    seeded with ``seed + 1`` (the weights take ``seed``), a single graph's
    edges cut to the rank's share."""
    from repro_torch.models.schnet import SchNet
    from repro_torch.train.train_loop import to_device

    base: SchNetConfig = spec.config
    n_dev = layout.cards
    batched = shape.kind == "gnn_batched"
    n_nodes, n_edges, d_feat = (
        (shape.n_nodes, shape.n_edges, MOLECULE_D_IN) if batched
        else gnn_sizes(shape))
    cfg = dataclasses.replace(base, d_in=d_feat)
    policy = train_policy(spec, layout, device)
    model = SchNet(cfg, device=device, generator=_generator(device, seed),
                   policy=policy)
    meta = {"kind": "train", "compute": "f32"}
    if policy is not None:
        meta["policy"] = _policy_meta(policy, model)
    if device.type == "meta":
        if batched:
            b = ceil_to(shape.global_batch, n_dev) // layout.cards
            lead, ids = (b, n_nodes), (b, n_edges)
            specs = {"energy": Input((b,), torch.float32)}
        else:
            lead, ids = (n_nodes,), (ceil_to(n_edges, n_dev) // n_dev,)
            specs = {"targets": Input((n_nodes,), torch.float32),
                     "node_mask": Input((n_nodes,), torch.float32)}
        specs.update(node_feat=Input((*lead, d_feat), torch.float32),
                     senders=Input(ids, torch.int32),
                     receivers=Input(ids, torch.int32),
                     distances=Input(ids, torch.float32))
        batch = _materialize(specs, device, None)
    else:
        arrays, info = gnn_batch(shape, seed + 1, n_dev, cfg.cutoff)
        if policy is not None and not batched:
            arrays = pol.shard_batch(arrays, pol.gnn_batch_dims(policy),
                                     policy.mesh,
                                     pol.rank_coords(policy, device))
        batch = to_device(arrays, device)
        meta.update(info)
    plan = policy and model.train_plan(batched)
    if batched:
        bsz = ceil_to(shape.global_batch, n_dev)
        meta["batched"] = True
        return Cell(spec.arch_id, shape.name, layout.name,
                    _train_step(model.batched_energy_loss, plan),
                    _train_args(model, batch),
                    _gnn_model_flops(cfg, bsz * n_nodes, bsz * n_edges,
                                     d_feat), meta, model)
    meta.update(edges_padded=ceil_to(n_edges, n_dev), nodes=n_nodes)
    return Cell(spec.arch_id, shape.name, layout.name,
                _train_step(model.loss_fn, plan), _train_args(model, batch),
                _gnn_model_flops(cfg, n_nodes, n_edges, d_feat), meta, model)


# ---------------------------------------------------------------------------
# RecSys cells


def _recsys_model_flops(cfg: RecsysConfig, batch: int, train: bool) -> float:
    d = cfg.embed_dim
    f = cfg.n_sparse
    per_ex = 0.0
    if cfg.model == "din":
        per_ex += cfg.seq_len * (4 * d * cfg.attn_mlp[0] * 2 + d)
        per_ex += (d * 2 + f * d) * cfg.mlp_dims[0] * 2
    elif cfg.model == "dien":
        g = cfg.gru_dim
        per_ex += cfg.seq_len * 2 * (3 * (d * g + g * g) + 3 * (g * g + g * g))
        per_ex += (g + d + f * d) * cfg.mlp_dims[0] * 2
    elif cfg.model == "autoint":
        h, da = cfg.n_attn_heads, cfg.d_attn
        d_in = d
        for _ in range(cfg.n_attn_layers):
            per_ex += 2 * (4 * f * d_in * h * da + 2 * f * f * h * da)
            d_in = h * da
    elif cfg.model == "xdeepfm":
        h_prev = f
        for h_k in cfg.cin_layers:
            per_ex += 2 * h_prev * f * h_k * d
            h_prev = h_k
        per_ex += 2 * f * d * cfg.mlp_dims[0] + 2 * cfg.mlp_dims[0] * cfg.mlp_dims[1]
    mults = 3.0 if train else 1.0
    return per_ex * batch * mults


def _recsys_batch(cfg: RecsysConfig, batch: int) -> dict:
    f = cfg.n_sparse
    out = {
        "sparse_ids": Input((batch, f), torch.int32,
                            ("int", min(cfg.vocab_sizes))),
        "label": Input((batch,), torch.float32, ("bernoulli",)),
    }
    if cfg.seq_len:
        out["hist_ids"] = Input((batch, cfg.seq_len), torch.int32,
                                ("int", cfg.item_vocab))
        out["hist_mask"] = Input((batch, cfg.seq_len), torch.float32,
                                 ("ones",))
        out["target_id"] = Input((batch,), torch.int32,
                                 ("int", cfg.item_vocab))
    return out


def _recsys_cell(spec: ArchSpec, shape: ShapeSpec, layout: Layout, device,
                 seed: int) -> Cell:
    from repro_torch.core import topk as topk_mod
    from repro_torch.models.recsys import build_model

    cfg: RecsysConfig = spec.config
    train = shape.kind == "recsys_train"
    policy = (train_policy if train else cell_policy)(spec, layout, device)
    model = build_model(cfg, device=device, seed=seed, policy=policy,
                        serving=not train)
    gen = _generator(device, seed + 1)
    n_dev = layout.cards
    meta = {"compute": "f32"}
    kernels = device.type != "meta"
    if policy is not None:
        meta["policy"] = _policy_meta(policy, model)

    if train:
        b = shape.global_batch
        batch = _materialize(_recsys_batch(cfg, b // n_dev), device, gen)
        return Cell(spec.arch_id, shape.name, layout.name,
                    _train_step(model.loss_fn, policy and model.train_plan()),
                    _train_args(model, batch),
                    _recsys_model_flops(cfg, b, True),
                    dict(meta, kind="train"), model)

    if shape.kind == "recsys_serve":
        b = ceil_to(shape.global_batch, n_dev)
        batch = _materialize(_recsys_batch(cfg, b // n_dev), device, gen)

        def serve_step(params, batch):
            return model.forward(batch, use_kernel=kernels)

        return Cell(spec.arch_id, shape.name, layout.name,
                    _no_grad(serve_step),
                    (dict(model.named_parameters()), batch),
                    _recsys_model_flops(cfg, b, False),
                    dict(meta, kind="serve"), model)

    # retrieval_cand: one user x 1M candidates -> top-k; each rank scores
    # its slice of the candidates, the top-ks are gathered and merged.
    c = ceil_to(shape.n_candidates, n_dev)
    b = max(shape.global_batch, 1)
    k = CANDIDATE_K
    user = _materialize(_recsys_batch(cfg, b), device, gen)
    cand = _materialize({"candidate_ids": Input(
        (c // n_dev,), torch.int32,
        ("int", cfg.item_vocab or cfg.vocab_sizes[0]))},
        device, gen)["candidate_ids"]

    def retrieval_step(params, batch, candidate_ids):
        scores = model.score_candidates(batch, candidate_ids,
                                        use_kernel=kernels)
        vals, pos = topk_mod.topk(scores, k)
        ids = candidate_ids.long()[pos]
        return topk_mod.merge_gathered(topk_mod.gather_shards(vals),
                                       topk_mod.gather_shards(ids), k)

    flops = _recsys_model_flops(cfg, c, False) if cfg.model == "din" else (
        2.0 * c * cfg.embed_dim * max(cfg.gru_dim, cfg.embed_dim) * b
    )
    return Cell(spec.arch_id, shape.name, layout.name,
                _no_grad(retrieval_step),
                (dict(model.named_parameters()), user, cand), flops,
                dict(meta, kind="retrieval", candidates=c, topk=k), model)


# ---------------------------------------------------------------------------
# Retrieval (gpusparse) cells


def _retrieval_cell(spec: ArchSpec, shape: ShapeSpec, layout: Layout, device,
                    seed: int) -> Cell:
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels.ell_gather.ref import ell_gather_ref

    cfg = spec.config
    n_shards = layout.cards
    k = RETRIEVAL_K
    specs = dist_mod.retrieval_input_specs(
        num_docs=shape.num_docs, vocab_size=cfg.vocab_size,
        batch=shape.global_batch, avg_doc_terms=cfg.avg_doc_terms,
        num_shards=n_shards)
    per = specs["docs_per_shard"]
    terms_s, values_s = specs["index"]
    gen = _generator(device, seed)
    # one rank's shard: [1, N/S, K]; padding slots hold vocab_size
    arrays = _materialize({
        "terms": Input((1, *terms_s.shape[1:]), terms_s.dtype,
                       ("int", cfg.vocab_size + 1)),
        "values": Input((1, *values_s.shape[1:]), values_s.dtype,
                        ("uniform", 0.01, 3.5)),
        "qw": Input(tuple(specs["qw"].shape), specs["qw"].dtype,
                    ("uniform", 0.0, 1.0)),
    }, device, gen)
    if device.type == "meta":
        # The sharded step's own harness (checks, local top-k, gather,
        # merge, tau) around the kernel's plain version.
        ctx = dist_mod._Group(None, 0, n_shards)

        def local_scores(local, queries, qw, tau_init, index):
            return ell_gather_ref(qw, local.terms, local.values)[:, :per]

        serve = dist_mod._sharded_step(ctx, k, per, dist_mod.ShardedEllIndex,
                                       None, local_scores)
    else:
        serve = dist_mod.make_serve_step(engine="ell", k=k,
                                         docs_per_shard=per)

    def serve_step(terms, values, qw):
        index = dist_mod.ShardedEllIndex(
            terms, values, per, shape.num_docs, cfg.vocab_size,
            num_shards=n_shards, held=0 if n_shards > 1 else None)
        vals, ids, _ = serve(index, qw=qw)
        return vals, ids

    # Useful work (paper §5.3): 2 FLOPs per (query-term x posting-entry)
    # intersection pair = 2 * B * q̄ * L̄ with L̄ = nnz / V.
    avg_q_terms = 50
    nnz = shape.num_docs * cfg.avg_doc_terms
    flops = 2.0 * shape.global_batch * avg_q_terms * (nnz / cfg.vocab_size)
    return Cell(spec.arch_id, shape.name, layout.name, _no_grad(serve_step),
                (arrays["terms"], arrays["values"], arrays["qw"]), flops,
                {"kind": "retrieval_serve", "num_docs": shape.num_docs,
                 "docs_per_shard": per, "topk": k, "compute": "f32",
                 "plain_kernels": (["ell_gather"] if device.type == "meta"
                                   else [])})


# ---------------------------------------------------------------------------
# Public factory

_FAMILIES = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
             "retrieval": _retrieval_cell}


def shape_of(spec: ArchSpec, shape_name: str) -> ShapeSpec:
    shape = next((s for s in spec.shapes if s.name == shape_name), None)
    if shape is None:
        raise KeyError(f"{spec.arch_id} has no shape {shape_name!r}")
    if shape.name in spec.skip_shapes:
        raise ValueError(
            f"{spec.arch_id}/{shape_name} is a documented skip: {spec.notes}"
        )
    return shape


def make_cell(spec: ArchSpec, shape: ShapeSpec, layout="single",
              device="meta", seed: int = 0, **kw) -> Cell:
    """The cell of ``spec`` (its config possibly cut, as the probes cut
    it) at ``shape``; ``kw`` passes ``microbatches`` and
    ``seq_parallel_on`` (JAX's decision forced) to an LM train cell."""
    lay = production_layout(layout) if isinstance(layout, str) else layout
    dev = resolve_device(device)
    try:
        return _FAMILIES[spec.family](spec, shape, lay, dev, seed, **kw)
    except Exception as e:
        e.add_note(f"cell {spec.arch_id}/{shape.name}/{lay.name}")
        raise


def build_cell(arch_id: str, shape_name: str, layout="single",
               device="meta", seed: int = 0) -> Cell:
    """The cell of a registered architecture and one of its shapes on
    ``layout``: ``meta`` inputs by default, seeded ones on ``device``."""
    spec = get_arch(arch_id)
    return make_cell(spec, shape_of(spec, shape_name), layout, device, seed)


def all_cells() -> list[tuple[str, str]]:
    out = []
    for a in list_archs():
        spec = get_arch(a)
        for s in spec.shapes:
            if s.name not in spec.skip_shapes:
                out.append((a, s.name))
    return out
