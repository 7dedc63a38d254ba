"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback."""
import os
import pkgutil
import py_compile
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import registry
from repro_torch.core.engine import RetrievalConfig, RetrievalEngine
from repro_torch.core.sparse import from_lists
from repro_torch.data.synthetic import make_corpus

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(ROOT, "src")
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_no_jax_and_no_repro():
    mods = _modules()
    for m in ("repro_torch.kernels.scatter_score.ops",
              "repro_torch.models.splade",
              "repro_torch.kernels.splade_head.ops",
              "repro_torch.models.transformer",
              "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.embedding_bag.ops",
              "repro_torch.models.recsys",
              "repro_torch.train.optimizer", "repro_torch.train.train_loop",
              "repro_torch.checkpoint.checkpoint",
              "repro_torch.runtime.fault_tolerance",
              "repro_torch.data.pipeline",
              "repro_torch.obs", "repro_torch.obs.metrics",
              "repro_torch.obs.trace", "repro_torch.obs.collect",
              "repro_torch.core.session", "repro_torch.sched.queue",
              "repro_torch.store", "repro_torch.store.format",
              "repro_torch.store.writer", "repro_torch.store.reader",
              "repro_torch.store.pager", "repro_torch.core.distributed",
              "repro_torch.launch", "repro_torch.launch.serve",
              "repro_torch.launch.train", "repro_torch.configs.base",
              "repro_torch.configs.qwen3_4b",
              "repro_torch.configs.smollm_135m",
              "repro_torch.configs.olmoe_1b_7b",
              "repro_torch.configs.mixtral_8x22b",
              "repro_torch.models.layers", "repro_torch.train.grad_compress",
              "repro_torch.configs.schnet", "repro_torch.models.schnet",
              "repro_torch.launch.cells", "repro_torch.launch.dryrun",
              "repro_torch.launch.mesh", "repro_torch.analysis.probes",
              "repro_torch.analysis.ops", "repro_torch.analysis.roofline",
              "repro_torch.analysis.report",
              "repro_torch.runtime.elastic", "repro_torch.sharding",
              "repro_torch.sharding.ctx", "repro_torch.sharding.policies",
              "repro_torch.lint", "repro_torch.lint.__main__",
              "repro_torch.lint.core", "repro_torch.lint.cache",
              "repro_torch.lint.obs_contract",
              "repro_torch.lint.registry_conformance",
              "repro_torch.lint.deprecation_shim",
              "repro_torch.lint.device_contract",
              "repro_torch.lint.host_sync", "repro_torch.lint.kernel_shape",
              "repro_torch.lint.accum_dtype",
              "repro_torch.lint.kernel_memory",
              "repro_torch.lint.kernel_race", "repro_torch.lint.sanitize",
              "repro_torch.lint.geometry"):
        assert m in mods
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    ids, vals = [np.array([1, 2], np.int32)], [np.ones(2, np.float32)]
    with pytest.raises(RuntimeError, match="cuda"):
        from_lists(ids, vals, vocab_size=4)
    with pytest.raises(RuntimeError, match="cuda"):
        make_corpus(10, vocab_size=50)
    docs = from_lists(ids, vals, vocab_size=4, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        RetrievalEngine(docs, RetrievalConfig(engine="tiled"))


def test_unknown_engine_lists_the_registered_ones():
    with pytest.raises(ValueError) as e:
        RetrievalConfig(engine="pallas")
    for name in ("dense", "ell", "tiled"):
        assert name in str(e.value)
    assert registry.available_engines() == (
        "bcoo", "dense", "ell", "segment", "tiled", "tiled-bmp-fused",
        "tiled-bmp-grouped", "tiled-pruned", "tiled-pruned-approx")


def test_chip_smoke_compiles_and_refuses_to_run_without_a_card(tmp_path):
    py_compile.compile(SMOKE, doraise=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    for script in (SMOKE, str(alone)):
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=120, cwd=os.path.dirname(script))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
