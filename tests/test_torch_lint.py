"""repro_torch.lint: the port's static-contract analyzer and its nine passes.

The dogfood gate (the port's tree is clean under every static pass), one
seeded violation for each pass under ``tests/fixtures/lint_torch/`` (each
must trip its pass: the linter's own regression suite; ``badpkg`` is the
port's form of the ``interpret=True`` bug, a CUDA branch that falls back to
the plain version), ``kernel-shape`` over all six kernel packages, the
suppression grammar, the CLI, the cache, and ``repro.lint`` and
``repro_torch.lint`` held to the same findings on the JAX package's own
fixtures where the contract is the same.  The device half needs the card
(``tests/test_torch_cuda.py``); here ``--device cuda`` must raise.
"""
import ctypes
import json
import os
import re

import pytest
import torch

from repro.lint import run_paths as jax_run_paths
from repro_torch.lint import make_passes, run_paths
from repro_torch.lint.__main__ import main

HERE = os.path.dirname(__file__)
FIXTURES = os.path.join(HERE, "fixtures", "lint_torch")
JAX_FIXTURES = os.path.join(HERE, "fixtures", "lint")
PORT = os.path.join(HERE, os.pardir, "src", "repro_torch")
PASS_IDS = {"device-contract", "host-sync", "registry-conformance",
            "kernel-shape", "deprecation-shim", "obs-contract",
            "kernel-memory", "kernel-race", "accum-dtype"}


def _fixture(*parts):
    return os.path.join(FIXTURES, *parts)


def _ids(report):
    return {f.pass_id for f in report.findings}


def _lines(report, pass_id):
    return sorted(f.line for f in report.findings if f.pass_id == pass_id)


def _marked(path, mark="# BAD"):
    """Lines of ``path`` carrying ``mark``."""
    with open(path) as f:
        return [i for i, ln in enumerate(f, start=1) if mark in ln]


# --- the dogfood gate -------------------------------------------------------


def test_port_tree_is_clean():
    """``python -m repro_torch.lint src/repro_torch`` exits 0 on the tree
    that ships it, every static pass run, more than 50 files walked."""
    report = run_paths([PORT])
    assert report.clean, "\n".join(f.format() for f in report.findings)
    assert report.files_checked > 50
    assert set(report.passes_run) == PASS_IDS
    assert report.suppressed >= 10  # the host syncs the path keeps


def test_every_suppression_in_the_port_carries_a_reason():
    pattern = re.compile(r"#\s*lint:\s*disable=([\w,-]+)(?:\s+--\s*(\S.*))?")
    found = 0
    for root, _, names in os.walk(PORT):
        for name in names:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(root, name)) as f:
                for line in f:
                    m = pattern.search(line)
                    if m and "<pass-id>" not in line:
                        found += 1
                        assert m.group(2), line
                        assert set(m.group(1).split(",")) <= PASS_IDS, line
    assert found >= 10


def test_list_passes_names_nine_with_their_kind(capsys):
    assert main(["--list-passes"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 9
    kinds = {ln.split()[0]: ln.split()[1] for ln in out}
    assert set(kinds) == PASS_IDS
    assert kinds["kernel-memory"] == "both"
    assert kinds["kernel-race"] == "device"
    assert all(kinds[p] == "static" for p in PASS_IDS
               - {"kernel-memory", "kernel-race"})


# --- one seeded fixture per pass --------------------------------------------


@pytest.mark.parametrize("target,pass_id", [
    ("kernels/badpkg", "device-contract"),
    ("kernels/uncounted", "device-contract"),
    ("host_sync_bad.py", "host-sync"),
    ("registry_bad.py", "registry-conformance"),
    ("kernels/noref", "kernel-shape"),
    ("kernels/splade_head", "kernel-shape"),
    ("kernels/embedding_bag", "kernel-shape"),
    ("distributed.py", "deprecation-shim"),
    ("obs_contract_bad.py", "obs-contract"),
    ("kernels/leaky", "kernel-memory"),
    ("kernels/halfsum", "accum-dtype"),
])
def test_fixture_trips_exactly_its_pass(target, pass_id):
    """Each seeded fault trips its pass and only its pass, under every
    static pass (the discrimination half of the contract)."""
    report = run_paths([_fixture(*target.split("/"))])
    assert _ids(report) == {pass_id}, \
        "\n".join(f.format() for f in report.findings)


def test_device_contract_catches_the_fallback_bug():
    """The CUDA branch wrapped in ``try: ... except: return *_ref(...)``:
    the try (C3), the handler's plain version (C3), the missing raise for
    other devices (C2) and the interpret parameter (C5)."""
    report = run_paths([_fixture("kernels", "badpkg")],
                       select=["device-contract"])
    text = " ".join(f.message for f in report.findings)
    for rule in ("(C2", "(C3)", "(C5)"):
        assert rule in text, text
    assert "`try`" in text and "`except`" in text
    assert len(report.findings) == 4


def test_device_contract_catches_unchecked_launches_and_cpu_defaults():
    report = run_paths([_fixture("kernels", "uncounted")],
                       select=["device-contract"])
    text = " ".join(f.message for f in report.findings)
    assert "not bound as `err = launch(...)`" in text  # C4
    assert "no checked launch precedes it" in text  # C4, the count
    assert "device='cpu'" in text  # C6
    assert len(report.findings) == 3


def test_host_sync_fixture_every_marked_line_and_no_other():
    path = _fixture("host_sync_bad.py")
    report = run_paths([path], select=["host-sync"])
    assert _lines(report, "host-sync") == _marked(path)
    text = " ".join(f.message for f in report.findings)
    for scope in ("an engine's score function", "a serve factory",
                  "a torch.compile function", "a CUDA graph capture"):
        assert scope in text


def test_host_sync_finds_the_known_round_trips_of_the_serve_path():
    """Without their suppressions, the pass finds the syncs the serve path
    keeps: the query-tile packing's one transfer, bmp_scan's launch sizes,
    the host planner's bounds, the top-k tie repair."""
    from repro_torch.lint.core import iter_python_files, load_file
    from repro_torch.lint.host_sync import HostSyncPass

    files = [load_file(p)[0] for p in iter_python_files([PORT])]
    raw = list(HostSyncPass().finalize(files))
    where = {(os.path.relpath(f.path, PORT), f.line) for f in raw}
    hits = {rel for rel, _ in where}
    for rel in ("kernels/query_tiles.py", "kernels/bmp_scan/ops.py",
                "core/scoring.py", "core/distributed.py", "core/topk.py"):
        assert rel in hits, rel
    for rel, line in where:  # each one carries a justified suppression
        with open(os.path.join(PORT, rel)) as f:
            lines = f.read().splitlines()
        ctx = next(c for c in files if os.path.relpath(c.path, PORT) == rel)
        ids, why = ctx.suppression_at(line)
        assert "host-sync" in ids and why, (rel, line, lines[line - 1])


def test_registry_conformance_fixture():
    path = _fixture("registry_bad.py")
    report = run_paths([path], select=["registry-conformance"])
    assert _lines(report, "registry-conformance") == _marked(path)
    text = " ".join(f.message for f in report.findings)
    assert "compute_dtype" in text
    assert "string comparison" in text


def test_deprecation_shim_fixture():
    report = run_paths([_fixture("distributed.py")],
                       select=["deprecation-shim"])
    text = " ".join(f.message for f in report.findings)
    assert "Deprecated" in text and "DeprecationWarning" in text
    assert "make_serve_step" in text
    assert len(report.findings) == 3


def test_obs_contract_fixture_and_exemptions():
    path = _fixture("obs_contract_bad.py")
    report = run_paths([path], select=["obs-contract"])
    assert _lines(report, "obs-contract") == _marked(path)
    from repro_torch.lint.obs_contract import ObsContractPass

    p = ObsContractPass()
    assert not p.applies_to("src/repro_torch/obs/metrics.py")
    assert p.applies_to("src/repro_torch/core/engine.py")


def test_kernel_memory_static_half_flags_the_unchecked_parameter():
    report = run_paths([_fixture("kernels", "leaky")],
                       select=["kernel-memory"])
    assert len(report.findings) == 1
    assert "`index`" in report.findings[0].message


def test_accum_dtype_fixture_every_marked_line_and_no_other():
    path = _fixture("kernels", "halfsum", "ref.py")
    report = run_paths([path], select=["accum-dtype"])
    assert _lines(report, "accum-dtype") == _marked(path)


# --- kernel-shape: the six packages on fake CUDA tensors -------------------


def test_kernel_shape_covers_every_package_and_both_dtypes():
    from repro_torch.lint.geometry import PACKAGES, ROUTES

    assert set(PACKAGES) == {r.package for r in ROUTES} == {
        "scatter_score", "ell_gather", "bmp_scan", "splade_head",
        "flash_attention", "embedding_bag"}
    bf16 = {r.package for r in ROUTES if r.dtype == torch.bfloat16}
    assert bf16 == {"scatter_score", "ell_gather", "bmp_scan",
                    "flash_attention"}


def _route_names():
    from repro_torch.lint.geometry import ROUTES

    return [r.name for r in ROUTES]


@pytest.mark.parametrize("name", _route_names())
def test_kernel_shape_route_agrees_with_its_plain_version(name):
    """The entry's CUDA branch on fake CUDA tensors: one recorded launch,
    every argument of the C type and value its shapes fix, and outputs of
    the plain version's shapes and dtypes on the card."""
    import importlib

    from repro_torch.lint.geometry import ROUTES
    from repro_torch.lint.kernel_shape import run_route

    route = next(r for r in ROUTES if r.name == name)
    ops = importlib.import_module(f"repro_torch.kernels.{route.package}.ops")
    before = ops.launches
    assert run_route(route, ops) == []
    assert ops.launches == before  # a recorded launch counts nothing


def test_kernel_shape_catches_a_wrong_output_dtype():
    report = run_paths([_fixture("kernels", "splade_head")],
                       select=["kernel-shape"])
    assert report.findings
    assert all("dtype torch.bfloat16" in f.message for f in report.findings)


def test_kernel_shape_catches_swapped_launch_integers():
    report = run_paths([_fixture("kernels", "embedding_bag")],
                       select=["kernel-shape"])
    text = " ".join(f.message for f in report.findings)
    assert "argument 6" in text and "argument 7" in text


def test_kernel_shape_reports_a_package_without_a_plain_version():
    report = run_paths([_fixture("kernels", "noref")],
                       select=["kernel-shape"])
    assert len(report.findings) == 1
    assert "*_ref" in report.findings[0].message


# --- the device half, here ---------------------------------------------------


def test_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the device half runs (see "
                    "tests/test_torch_cuda.py)")
    with pytest.raises(RuntimeError, match="cuda"):
        run_paths([_fixture("obs_contract_bad.py")], device="cuda",
                  select=["kernel-race"])
    with pytest.raises(RuntimeError, match="cuda"):
        main([_fixture("obs_contract_bad.py"), "--device", "cuda",
              "--select", "kernel-memory,kernel-race"])


def test_sanitizer_output_is_read_route_by_route():
    from repro_torch.lint import sanitize

    text = "\n".join([
        "@@begin a",
        "========= Invalid __global__ read of size 4 bytes",
        "=========     at k+0x10 in /x/src/repro_torch/csrc/ell_gather.cu:123",
        '@@end a {"max_abs_err": 0.0}',
        "@@begin b",
        "========= Warning: cp.async.bulk is not supported by racecheck",
        '@@end b {"max_abs_err": 0.0}',
        "@@begin c",
        '@@end c {"max_abs_err": 0.0}',
        "@@begin d",
    ])
    got = sanitize._parse("racecheck", text, ["a", "b", "c", "d"])
    assert got["a"]["racecheck"].startswith("errors: Invalid")
    assert got["a"]["cu_line"] == ["/x/src/repro_torch/csrc/ell_gather.cu",
                                   123]
    assert got["b"]["racecheck"].startswith("not checked")
    assert got["c"]["racecheck"] == "clean"
    assert "d" not in got  # the child died there


def test_device_results_become_findings_and_unchecked_routes():
    from repro_torch.lint import sanitize

    results = {"tool": "compute-sanitizer", "routes": {
        "bmp_scan/small/f32": {"memcheck": "clean", "racecheck":
                               "not checked: tma", "guard": "clean",
                               "plain": "clean",
                               "repeat": "errors: the bits differ"},
        "embedding_bag/vec1": {"memcheck": "errors: Invalid read",
                               "racecheck": "clean", "guard": "clean",
                               "plain": "clean", "repeat": "clean"},
    }}
    mem = sanitize.memory_findings(results)
    race = sanitize.race_findings(results)
    assert [f.message.split(":")[0] for f in mem] == ["embedding_bag/vec1"]
    assert mem[0].path.endswith("csrc/embedding_bag.cu")
    assert [f.message.split(":")[0] for f in race] == ["bmp_scan/small/f32"]
    assert sanitize.unchecked(results) == {
        "bmp_scan/small/f32": {"racecheck": "not checked: tma"}}


def test_guard_band_sees_a_write_past_an_operand():
    """The guard moves each operand into a band; a launch that writes one
    element past its output leaves a mark there (here a host "launch" that
    copies through the pointers it is handed)."""
    from repro_torch.lint import sanitize

    def launch(src, dst, n, overrun):
        ctypes.memmove(dst, src, 4 * n)
        ctypes.memset(dst + 4 * n, 0, 4 * overrun)  # one float too many
        return 0

    argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int)
    for overrun, bad in ((0, False), (1, True)):
        x, y = torch.arange(8, dtype=torch.float32), torch.zeros(8)
        guard = sanitize._Guard(torch.device("cpu"), 0xFF)
        data_ptr = torch.Tensor.data_ptr
        torch.Tensor.data_ptr = guard.record(data_ptr)
        try:
            args = (x.data_ptr(), y.data_ptr(), 8, overrun)
        finally:
            torch.Tensor.data_ptr = data_ptr
        assert guard.wrap(launch, argtypes, data_ptr)(*args) == 0
        assert bool(guard.problems) == bad, guard.problems
        assert torch.equal(y, x)  # the result comes back to the operand


# --- suppressions -----------------------------------------------------------


def test_suppression_semantics():
    report = run_paths([_fixture("suppressed.py")], select=["obs-contract"])
    assert report.suppressed == 1
    sup = [f for f in report.findings if f.pass_id == "suppression"]
    assert len(sup) == 1 and "justification" in sup[0].message
    assert len(_lines(report, "obs-contract")) == 1


def test_span_suppression_covers_a_multiline_statement(tmp_path):
    mod = tmp_path / "span_ok.py"
    mod.write_text(
        "import time\n"
        "x = (  # lint: disable=obs-contract -- span-rule regression\n"
        "    1.0\n"
        "    + time.perf_counter()\n"
        ")\n"
    )
    report = run_paths([str(mod)], select=["obs-contract"])
    assert report.clean and report.suppressed == 1


def test_span_suppression_does_not_leak_into_compound_bodies(tmp_path):
    mod = tmp_path / "span_bad.py"
    mod.write_text(
        "import time\n"
        "def f():  # lint: disable=obs-contract -- must not cover body\n"
        "    return time.perf_counter()\n"
    )
    report = run_paths([str(mod)], select=["obs-contract"])
    assert _ids(report) == {"obs-contract"}
    assert report.findings[0].line == 3


# --- the same contract, the same findings as repro.lint ---------------------


@pytest.mark.parametrize("fixture", ["registry_bad.py", "distributed.py",
                                     "obs_contract_bad.py", "suppressed.py"])
def test_shared_fixtures_give_repro_lints_findings(fixture):
    """On the JAX package's own fixtures (read only), the three passes whose
    contract is the same give the same (line, pass id) findings in both
    packages."""
    select = ["registry-conformance", "deprecation-shim", "obs-contract"]
    path = os.path.join(JAX_FIXTURES, fixture)
    jax_report = jax_run_paths([path], select=select)
    port_report = run_paths([path], select=select)
    want = {(f.line, f.pass_id) for f in jax_report.findings}
    assert want  # each fixture trips something
    assert {(f.line, f.pass_id) for f in port_report.findings} == want
    assert port_report.suppressed == jax_report.suppressed


# --- CLI ---------------------------------------------------------------------


@pytest.mark.parametrize("argv,code", [
    ([os.path.join(PORT, "obs")], 0),
    ([_fixture("kernels", "badpkg")], 1),
    ([_fixture("host_sync_bad.py"), "--select", "host-sync,obs-contract"], 1),
    ([_fixture("obs_contract_bad.py"), "--select", "no-such-pass"], 2),
])
def test_cli_exit_codes(argv, code, capsys):
    assert main(argv) == code


def test_cli_json_format(capsys):
    assert main([_fixture("distributed.py"), "--format", "json",
                 "--select", "deprecation-shim"]) == 1
    payload = json.loads(capsys.readouterr().out)
    assert payload["clean"] is False
    assert payload["passes"] == ["deprecation-shim"]
    assert payload["device"] is None
    assert {f["pass_id"] for f in payload["findings"]} == {
        "deprecation-shim"}


def test_lint_modules_import_without_running(capsys):
    import importlib

    for m in ("repro_torch.lint.__main__", "repro_torch.lint.sanitize"):
        importlib.import_module(m)
    assert capsys.readouterr().out == ""


# --- the cache ---------------------------------------------------------------


def test_cache_warm_run_replays_the_findings(tmp_path):
    from repro_torch.lint.cache import LintCache

    target = os.path.join(FIXTURES, "kernels")
    cache_path = str(tmp_path / "cache.json")
    roster = [p.pass_id for p in make_passes()]
    cold = run_paths([target], cache=LintCache(cache_path, roster))
    assert cold.from_cache == 0 and os.path.exists(cache_path)
    warm = run_paths([target], cache=LintCache(cache_path, roster))
    assert warm.from_cache == warm.files_checked == cold.files_checked
    assert [f.format() for f in warm.findings] == \
        [f.format() for f in cold.findings]
    assert warm.suppressed == cold.suppressed


def test_cache_drops_everything_when_the_tree_or_roster_changes(tmp_path):
    from repro_torch.lint.cache import LintCache

    a, b = tmp_path / "a.py", tmp_path / "b.py"
    a.write_text("x = 1\n")
    b.write_text("y = 1\n")
    path = str(tmp_path / "c.json")
    roster = ["obs-contract"]
    assert run_paths([str(tmp_path)], cache=LintCache(path, roster)
                     ).from_cache == 0
    assert run_paths([str(tmp_path)], cache=LintCache(path, roster)
                     ).from_cache == 2
    b.write_text("y = 2\n")  # another file changed: a's entry goes too
    assert run_paths([str(tmp_path)], cache=LintCache(path, roster)
                     ).from_cache == 0
    assert run_paths([str(tmp_path)], cache=LintCache(path, ["host-sync"])
                     ).from_cache == 0


def test_cli_cache_flag(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "m.py").write_text("x = 1\n")
    assert main(["m.py", "--cache"]) == 0
    assert (tmp_path / ".lint-cache-torch.json").exists()
    assert main(["m.py", "--cache"]) == 0
