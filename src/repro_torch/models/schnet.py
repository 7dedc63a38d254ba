"""SchNet [arXiv:1706.08566]: continuous-filter convolutions over graphs
(``repro.models.schnet``).

Message passing is gather -> RBF-filter weighting -> scatter-add: JAX's
``jnp.take`` + ``jax.ops.segment_sum`` are ``index_select`` +
``index_add_`` here, plain PyTorch (no Pallas kernel lies under them in
JAX either).  Distances feed a Gaussian radial-basis expansion with a
cosine cutoff; three interaction blocks by default.  Everything runs f32
(TF32 is PyTorch's default off for matmuls).

``SchNet(cfg, device="cuda", generator=None)`` holds the JAX params
pytree's leaves under the same names, one interaction per entry where JAX
stacks them [n_int, ...] for ``scan``: ``embed_in`` [max(d_in, 1), d],
``embed_bias`` [d], ``interactions.<i>.{filter_w1, filter_w2, in_proj,
out_proj1, out_proj2}``, ``head1`` [d, d/2], ``head2`` [d/2, n_out],
drawn from ``generator`` with the JAX init's laws (other numbers: carry
JAX weights with :func:`params_from_jax`).  On ``meta`` they are empty
tensors of those shapes.

Ids outside the graph keep JAX's meaning, without a host sync: a sender
``s`` in [-N, 0) reads node ``s + N`` (``jnp.take`` wraps it) and one
outside [-N, N) reads NaN (``jnp.take`` fills); a receiver outside [0, N)
is dropped (``segment_sum`` drops it), so padded edges take sender 0 and
receiver N.  A NaN sender poisons the filter's gradient even though its
message is dropped (0 x NaN), as in JAX.  ``batched_energy_loss`` runs
the B molecules as one graph of B n nodes, each molecule's ids mapped
into its own block of n, so an id outside [0, n) keeps its per-molecule
meaning (JAX vmaps ``forward`` over the molecules).

Under a sharding policy (``SchNet(cfg, device, generator,
policy=make_policy(mesh))``; every parameter replicated,
``gnn_param_specs``) the batch is split by ``gnn_batch_dims``.  A full
graph's edges are split over every axis and its nodes replicated: each
rank computes the RBFs, the filter MLP and the messages of its edges and
adds them into a local [N, d], then one SUM all-reduce a interaction
gives every rank the whole aggregate (the node states enter the rank's
edges through ``ctx.enter_split``, so their gradient is summed too).
The node-level layers then run the same on every rank, so only the
filter MLP's gradients are partial sums (``train_plan``).  Molecule
batches are split by graphs over every axis, and the loss is the whole
batch's mean (the rank's sum of squared errors all-reduced, then
divided); every gradient is then a partial sum.  The id semantics hold
per edge, as unsharded.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import SchNetConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding import ctx
from repro_torch.sharding import policies as pol
from repro_torch.utils import resolve_device, stack_layers, unstack_layers

INTERACTION_LEAVES = ("filter_w1", "filter_w2", "in_proj", "out_proj1",
                      "out_proj2")
LOG2 = math.log(2.0)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus(x) - log 2``: JAX's softplus is ``logaddexp(x,
    0)`` (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device)) - LOG2


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis: centers linspaced on [0, cutoff]."""
    centers = torch.linspace(0.0, cutoff, n_rbf, device=dist.device)
    gamma = 10.0 / cutoff
    return torch.exp(-gamma * (dist[..., None] - centers) ** 2)


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    c = 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)
    return torch.where(dist < cutoff, c, 0.0)


def edge_index(senders: torch.Tensor, receivers: torch.Tensor, n: int,
               offset=0, dump: Optional[int] = None):
    """JAX's id semantics for a graph of ``n`` nodes whose rows start at
    ``offset`` (an int, or a tensor broadcast against the ids) ->
    (``send``: int64 rows to gather, ``send_ok``: False where ``jnp.take``
    fills, ``recv``: int64 rows to add into, ``dump`` where
    ``segment_sum`` drops).  ``dump`` defaults to ``offset + n``."""
    s = senders.long()
    s = torch.where(s < 0, s + n, s)
    send_ok = (s >= 0) & (s < n)
    send = torch.where(send_ok, s, 0) + offset
    r = receivers.long()
    recv_ok = (r >= 0) & (r < n)
    recv = torch.where(recv_ok, r + offset, offset + n if dump is None
                       else dump)
    return send, send_ok, recv


class SchNet(nn.Module):
    def __init__(self, cfg: SchNetConfig, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 policy: Optional[pol.ShardingPolicy] = None):
        super().__init__()
        dev = resolve_device(device)
        if policy is not None:
            pol.rank_coords(policy, dev)  # raises without a matching group
        self.policy = policy
        gen = generator if generator is not None else torch.Generator()
        d, r = cfg.d_hidden, cfg.n_rbf
        self.cfg = cfg
        self.embed_in = nn.Parameter(dense_init(gen, max(cfg.d_in, 1), d,
                                                device=dev))
        self.embed_bias = nn.Parameter(torch.zeros(d, device=dev))
        shapes = {"filter_w1": (r, d), "filter_w2": (d, d),
                  "in_proj": (d, d), "out_proj1": (d, d),
                  "out_proj2": (d, d)}
        self.interactions = nn.ModuleList([
            nn.ParameterDict({name: nn.Parameter(dense_init(
                gen, *shapes[name], device=dev))
                for name in INTERACTION_LEAVES})
            for _ in range(cfg.n_interactions)])
        self.head1 = nn.Parameter(dense_init(gen, d, d // 2, device=dev))
        self.head2 = nn.Parameter(dense_init(gen, d // 2, cfg.n_out,
                                             device=dev))
        self.specs = (None if policy is None else pol.gnn_param_specs(
            policy, dict(self.named_parameters())))

    @property
    def device(self) -> torch.device:
        return self.embed_in.device

    def _axes(self):
        p = self.policy
        return (contextlib.nullcontext() if p is None
                else ctx.axes(p.mesh, p.dp, p.tp))

    def _interaction(self, p, x, send, send_ok, recv, rbf, cut,
                     split: bool = False):
        """cfconv + atom-wise update (SchNet interaction block); ``split``:
        the edges are this rank's share of the graph's (the messages'
        aggregate summed over every rank)."""
        w = shifted_softplus(rbf @ p["filter_w1"])
        w = shifted_softplus(w @ p["filter_w2"])  # [E, d]
        w = w * cut[:, None]
        h = x @ p["in_proj"]
        if split:
            h = ctx.enter_split(h, "all")
        gathered = torch.where(send_ok[:, None], h.index_select(0, send),
                               float("nan"))
        msgs = gathered * w  # gather + filter
        n = x.shape[0]
        agg = torch.zeros((n + 1, h.shape[1]), dtype=msgs.dtype,
                          device=msgs.device).index_add_(0, recv, msgs)[:n]
        if split:
            agg = ctx.all_reduce_sum(agg, "all")
        v = shifted_softplus(agg @ p["out_proj1"]) @ p["out_proj2"]
        return x + v

    def node_embed(self, node_feat: torch.Tensor) -> torch.Tensor:
        return shifted_softplus(node_feat @ self.embed_in + self.embed_bias)

    def _forward(self, node_feat, send, send_ok, recv, distances,
                 split: bool = False):
        cfg = self.cfg
        x = self.node_embed(node_feat)
        rbf = rbf_expand(distances, cfg.n_rbf, cfg.cutoff)
        cut = cosine_cutoff(distances, cfg.cutoff)
        for p in self.interactions:
            x = self._interaction(p, x, send, send_ok, recv, rbf, cut, split)
        h = shifted_softplus(x @ self.head1)
        return h @ self.head2

    def forward(self, node_feat, senders, receivers, distances):
        """-> per-node outputs [N, n_out]; under a policy the edges are
        this rank's share of the graph's."""
        dev = self.device
        node_feat = node_feat.to(dev)
        send, send_ok, recv = edge_index(senders.to(dev), receivers.to(dev),
                                         node_feat.shape[0])
        with self._axes():
            return self._forward(node_feat, send, send_ok, recv,
                                 distances.to(dev),
                                 ctx.group_size("all") > 1)

    # -- step functions -----------------------------------------------------
    def loss_fn(self, batch: dict):
        """Node-level regression MSE (full-graph / minibatch shapes) ->
        (mse, ``{"mse"}``).

        batch: node_feat [N, F], senders/receivers [E], distances [E],
        targets [N], (optional) node_mask [N]."""
        out = self.forward(batch["node_feat"], batch["senders"],
                           batch["receivers"], batch["distances"])[:, 0]
        mask = batch.get("node_mask")
        mask = (torch.ones_like(out) if mask is None
                else mask.to(out.device, torch.float32))
        targets = batch["targets"].to(out.device)
        mse = torch.sum(((out - targets) ** 2) * mask) / torch.clamp(
            torch.sum(mask), min=1.0)
        return mse, {"mse": mse.detach()}

    def batched_energy_loss(self, batch: dict):
        """Batched small molecules: per-graph energy = sum of node outputs
        -> (mse, ``{"mse"}``); under a policy the rank's molecules, the
        mean over the whole batch's.

        batch: node_feat [B, n, F], senders/receivers [B, e], distances
        [B, e], energy [B]."""
        dev = self.device
        nf = batch["node_feat"].to(dev)
        b, n, _ = nf.shape
        offset = (torch.arange(b, device=dev) * n)[:, None]
        send, send_ok, recv = edge_index(
            batch["senders"].to(dev), batch["receivers"].to(dev), n, offset,
            dump=b * n)
        out = self._forward(nf.reshape(b * n, -1), send.reshape(-1),
                            send_ok.reshape(-1), recv.reshape(-1),
                            batch["distances"].to(dev).reshape(-1))
        e = out.reshape(b, -1).sum(dim=1)
        err = (e - batch["energy"].to(dev)) ** 2
        with self._axes():
            n = ctx.group_size("all")
            mse = (torch.mean(err) if n == 1 else
                   ctx.all_reduce_sum(torch.sum(err), "all") / (b * n))
        return mse, {"mse": mse.detach()}

    def train_plan(self, batched: bool = False) -> pol.TrainPlan:
        """The sharded step's plan for ``loss_fn`` (a full graph, edges
        split: the filter MLP's gradients are partial sums over every
        axis, the node-level leaves whole) or ``batched_energy_loss``
        (molecules split: every leaf's gradient a partial sum)."""
        p = self.policy
        if p is None:
            raise ValueError("a train plan needs a policy")
        every = tuple(a for a in p.dp + (p.tp,)
                      if pol.axis_sizes(p.mesh)[a] > 1)
        edge_leaves = ("filter_w1", "filter_w2")
        return pol.TrainPlan(p, dict(self.specs), {
            name: every if batched or name.rsplit(".", 1)[-1] in edge_leaves
            else () for name in self.specs})


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """A JAX ``SchNet`` params pytree (numpy leaves, ``interactions``
    stacked [n_int, ...]) as the ``state_dict`` of :class:`SchNet`: CPU
    tensors, which ``load_state_dict`` copies to the module's device."""
    return unstack_layers(params, ("interactions",))


def params_to_jax(state: dict) -> dict:
    """The inverse of :func:`params_from_jax`: a ``state_dict`` (tensors or
    numpy arrays) as the JAX params pytree of numpy arrays, the
    interactions restacked [n_int, ...]."""
    return stack_layers(state, ("interactions",))
