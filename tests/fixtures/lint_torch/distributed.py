"""Fixture: a legacy serve-step factory of the port that stopped being a
shim: no Deprecated docstring, no DeprecationWarning, and a private build
path instead of make_serve_step.  deprecation-shim must flag D1, D2, D3."""


def _build_ell_step(group, k, docs_per_shard):
    return lambda index, qw: (qw, index)


def make_retrieval_serve_step(group=None, *, k, docs_per_shard):
    """Build the ell serve step."""
    return _build_ell_step(group, k, docs_per_shard)
