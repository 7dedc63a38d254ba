"""Fixture: host round trips on the serve path.  host-sync must flag every
line marked BAD, reached through each kind of scope (a wired engine score
function and the helper it calls, a serve factory's step closure, a
torch.compile function, a CUDA-graph capture), and leave the rest."""
import numpy as np
import torch

from repro_torch.core.registry import register_engine, register_serve_factory
from repro_torch.store import SegmentReader


def _build(docs, cfg):
    return docs


def _helper(scores, k):
    top = scores.topk(k).values
    return top.tolist()  # BAD: reached from the score function


@register_engine("fixture-sync", build_index=_build)
def score_with_syncs(queries, index, cfg, k=None, tau_init=None):
    scores = queries @ index
    n = int(scores.shape[0])  # allowed: a shape
    best = scores.max().item()  # BAD
    tau = float(scores[0, 0])  # BAD: a cast of a tensor
    kept = (scores > 0).nonzero()  # BAD: sized by the data
    host = np.asarray(scores)  # BAD
    return scores, n, best, tau, kept, host, _helper(scores, k)


@register_serve_factory("fixture-sync")
def make_fixture_step(ctx, *, k, docs_per_shard, geometry, cfg,
                      hierarchical_merge, compute_dtype):
    def serve_step(index, queries=None, qw=None, tau_init=None,
                   deleted_mask=None):
        torch.cuda.synchronize()  # BAD
        with open("/dev/null") as f:  # BAD
            f.read()
        reader = SegmentReader("segments")  # BAD
        return qw.cpu()  # BAD
    return serve_step


@torch.compile
def compiled(x):
    return x * float(x.sum())  # BAD


def captured(graph, x):
    with torch.cuda.graph(graph):
        y = x.numpy()  # BAD
    return y


def not_on_the_path(x):
    return x.item()  # allowed: no scope reaches it
