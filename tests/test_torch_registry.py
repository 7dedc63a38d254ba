"""The port's deprecated ``score_with_engine`` and ``repro_torch.core``'s
public names, against the JAX package on the CPU.

* every registered engine name warns (``DeprecationWarning`` naming
  ``score_with_engine``) and gives JAX's ``score_with_engine`` result on
  the same seeded corpus, with the engine's default index and, for the
  engines of a ``TiledIndex``, with a fine-bound one at doc_block 16
  handed in: the same ``-inf`` positions (the pruned engines' skipped
  docs) and the finite scores within rtol 1e-5 / atol
  1e-6.  ``tiled-bmp-fused`` is held against JAX's ``tiled-bmp-grouped``:
  the reference fused Pallas kernel does not trace on this JAX, and by
  contract the two engines return the same scores;
* an index of the engine's type is used as given, any other is rebuilt;
* every name of JAX's ``repro.core.__all__`` is in
  ``repro_torch.core.__all__`` and imports from it.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from _torch_parity import ATOL, RTOL, port_batch
from repro.core import index as jidx
from repro.core import scoring as jscoring
from repro.data import synthetic as jsyn
from repro_torch.core import index as tidx
from repro_torch.core import registry as tregistry
from repro_torch.core import scoring as tscoring

K = 10
GEOM = dict(term_block=256, doc_block=16, chunk_size=32,
            store_term_block_max=True)
# The port's engine name -> JAX's reference engine name.
REFERENCE = {"tiled-bmp-fused": "tiled-bmp-grouped"}


@pytest.fixture(scope="module")
def corpus():
    """JAX's topical corpus reordered by ``df-signature`` (one numpy copy
    for both packages), so that doc blocks of 16 prune."""
    c = jsyn.make_topical_corpus(1001, 6, vocab_size=1500, num_topics=6,
                                 topic_vocab=150, seed=5)
    docs, _ = jidx.reorder_docs(c.docs, method="df-signature")
    return c.queries, docs


def _both(c, name, index: bool):
    """The port's and JAX's ``score_with_engine`` on the same corpus;
    ``index`` hands both a fine-bound ``TiledIndex`` at doc_block 16 (each
    package's own build of it), else each builds the engine's default."""
    q, docs = c
    ref = REFERENCE.get(name, name)
    tkw, jkw = {}, {}
    if index:
        tkw["index"] = tidx.build_tiled_index(port_batch(docs), **GEOM)
        jkw["index"] = jidx.build_tiled_index(docs, **GEOM)
    with pytest.warns(DeprecationWarning, match="score_with_engine"):
        got = tscoring.score_with_engine(name, port_batch(q),
                                         port_batch(docs), k=K, **tkw)
    with pytest.warns(DeprecationWarning, match="score_with_engine"):
        want = jscoring.score_with_engine(ref, q, docs, k=K, **jkw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", tregistry.available_engines())
def test_score_with_engine_warns_and_equals_jax(corpus, name):
    spec = tregistry.get_engine(name)
    for index in (False, True) if spec.index_type is tidx.TiledIndex \
            else (False,):
        got, want = _both(corpus, name, index)
        assert got.shape == want.shape == (6, 1001)
        skipped = np.isneginf(want)
        np.testing.assert_array_equal(np.isneginf(got), skipped)
        np.testing.assert_allclose(got[~skipped], want[~skipped], rtol=RTOL,
                                   atol=ATOL)
        if not spec.pruned:
            assert not skipped.any()
        elif index and name in ("tiled-bmp-grouped", "tiled-bmp-fused"):
            # A group's sweep skips blocks of 16 docs here; the batch-wide
            # traversals keep every block some query of the six needs.
            assert skipped.any()


def test_score_with_engine_uses_an_index_of_its_type(corpus, monkeypatch):
    """A ``TiledIndex`` given to ``tiled`` is scored as given; an
    ``EllIndex`` given to it is not of its type, so the docs are
    indexed."""
    q, docs = port_batch(corpus[0]), port_batch(corpus[1])
    built = []
    spec = tregistry.get_engine("tiled")
    monkeypatch.setitem(tregistry._REGISTRY, "tiled", tregistry.EngineSpec(
        **{**spec.__dict__, "build_index": lambda d, cfg: built.append(1)
           or spec.build_index(d, cfg)}))
    index = tidx.build_tiled_index(docs)
    with pytest.warns(DeprecationWarning):
        got = tscoring.score_with_engine("tiled", q, docs, index=index)
    assert not built
    with pytest.warns(DeprecationWarning):
        again = tscoring.score_with_engine("tiled", q, docs,
                                           index=tidx.build_ell_index(docs))
    assert built == [1]
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match="registered engines"), \
            pytest.warns(DeprecationWarning):
        tscoring.score_with_engine("pallas", q, docs)


def test_core_exports_every_name_jax_core_exports():
    missing = sorted(set(jcore.__all__) - set(tcore.__all__))
    assert not missing, missing
    for name in tcore.__all__:
        assert getattr(tcore, name) is not None, name
    assert tcore.score_with_engine is tscoring.score_with_engine
    assert tcore.topk.topk is not None  # the module, as in JAX
