"""The port's fedlint (``repro_torch.lint``) against the reference's
(``repro.lint``) and on its own seeded fixtures.

  * On the reference's fixtures of the passes both packages share
    (fleet-scale, wire-decode, obs-events, wire-format), loaded under
    ``src/repro_torch/federated/`` and ``src/repro/federated/``, both lints
    give the same (rule, line) set, equal to the ``# SEED:`` markers, and
    the same suppression tables and ``findings_to_json`` bytes.
  * The port's fixtures (``tests/torch_lint_fixtures/``: host-sync,
    autograd.Function, mesh, CUDA and kernel-fallback) are hit at exactly
    their marked lines, the clean ones at none, and every registered pass
    and rule is hit.
  * The port's tree (``src/repro_torch`` and ``chip_smoke.py``) lints to
    nothing, its wire manifest is current, and its hash does not move with
    the Python version.
  * The CLI's exit codes, ``--json`` and ``--list-rules``; the package and
    its CLI with jax and ``repro`` blocked from import.
  * The dispatch helpers: host syncs by op and line, one FEMNIST step's
    syncs on the CPU, collectives on a one-rank ``("clients",)`` mesh, the
    gradients ``autograd.Function``s give integer inputs.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.lint import core as jcore
from repro.lint import wire_checks as jwire
from repro_torch.lint import (DEFAULT_PATHS, available_passes,
                              findings_to_json, rule_catalogue, run_lint,
                              wire_checks)
from repro_torch.lint import dispatch
from repro_torch.lint.core import (Finding, Module, is_test_path,
                                   iter_python_files, make_passes,
                                   run_passes)

REPO_ROOT = Path(__file__).resolve().parent.parent
REF_FIXTURES = Path(__file__).resolve().parent / "lint_fixtures"
FIXTURES = Path(__file__).resolve().parent / "torch_lint_fixtures"
ENV = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))

SHARED_PASSES = ["fleet-scale", "obs-events", "wire-decode", "wire-format"]
REF_SHARED_FIXTURES = ["fleet_loops_bad.py", "fleet_loops_clean.py",
                       "obs_events_bad.py", "obs_events_clean.py",
                       "wire_bad.py", "wire_clean.py",
                       "wire_decode_bad.py", "wire_decode_clean.py"]
# fixture -> the pseudo-directory it is linted under (path-gated rules)
PORT_FIXTURES = {
    "host_sync_bad.py": "src/repro_torch/core/",
    "host_sync_clean.py": "src/repro_torch/core/",
    "host_sync_kernels_bad.py": "src/repro_torch/kernels/",
    "vjp_bad.py": "fixtures/",
    "vjp_clean.py": "fixtures/",
    "mesh_bad.py": "fixtures/",
    "mesh_clean.py": "fixtures/",
    "fallback_bad.py": "src/repro_torch/kernels/",
    "fallback_clean.py": "src/repro_torch/kernels/",
    "cuda_bad.cu": "src/repro_torch/csrc/",
}
CUDA_CLEAN = ("cuda_clean.cu", "cuda_clean.cuh")

_SEED_RE = re.compile(r"(?:#|//)\s*SEED:\s*(?P<rules>[a-z0-9,\- ]+)$")


def _seeds(source: str):
    out = []
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _SEED_RE.search(line)
        if m:
            out.extend((r.strip(), lineno)
                       for r in m.group("rules").split(","))
    return sorted(out)


def _load(name: str) -> Module:
    return Module(PORT_FIXTURES[name] + name, (FIXTURES / name).read_text())


def _cuda_clean(**edits):
    """The clean CUDA fixture and its header, with ``old=new`` edits."""
    mods = []
    for name in CUDA_CLEAN:
        src = (FIXTURES / name).read_text()
        for old, new in edits.get(name, []):
            assert old in src
            src = src.replace(old, new)
        mods.append(Module(f"src/repro_torch/csrc/{name}", src))
    return mods


def _got(mods, select=None):
    return sorted({(f.rule, f.line)
                   for f in run_passes(mods, make_passes(select))})


@pytest.fixture
def tmp_manifests(tmp_path, monkeypatch):
    """Both packages' wire manifests pointed at scratch files."""
    monkeypatch.setattr(wire_checks, "MANIFEST_PATH", tmp_path / "t.json")
    monkeypatch.setattr(jwire, "MANIFEST_PATH", tmp_path / "j.json")
    return tmp_path


# ---------------------------------------------------------------------------
# parity with the reference on its fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", REF_SHARED_FIXTURES)
def test_shared_passes_match_the_reference(name, tmp_manifests):
    """Same (rule, line) set from both lints, each under its own package's
    federated path, and equal to the fixture's SEED markers."""
    src = (REF_FIXTURES / name).read_text()
    if name == "wire_clean.py":
        wire_checks.update_manifest([str(REF_FIXTURES / name)])
        jwire.update_manifest([str(REF_FIXTURES / name)])
    ref = sorted({(f.rule, f.line) for f in jcore.run_passes(
        [jcore.Module(f"src/repro/federated/{name}", src)],
        jcore.make_passes(SHARED_PASSES))})
    port = _got([Module(f"src/repro_torch/federated/{name}", src)],
                SHARED_PASSES)
    assert port == ref == _seeds(src)
    # the port's gates are its own package's paths, not the reference's
    assert _got([Module(f"src/repro/federated/{name}", src)],
                ["fleet-scale", "obs-events", "wire-decode"]) == []


@pytest.mark.parametrize("name", sorted(
    p.name for p in REF_FIXTURES.glob("*.py")))
def test_suppression_tables_match_the_reference(name):
    src = (REF_FIXTURES / name).read_text()
    ref, port = jcore.Module(f"x/{name}", src), Module(f"x/{name}", src)
    assert port.line_suppressions == ref.line_suppressions
    assert port.file_suppressions == ref.file_suppressions


def test_findings_json_is_the_references_byte_for_byte(tmp_manifests):
    ref_findings = []
    for name in ("fleet_loops_bad.py", "wire_bad.py", "wire_decode_bad.py",
                 "vjp_bad.py", "host_sync_bad.py"):
        src = (REF_FIXTURES / name).read_text()
        ref_findings += jcore.run_passes(
            [jcore.Module(f"src/repro/federated/{name}", src)],
            jcore.make_passes())
    assert len(ref_findings) > 10
    port_findings = [Finding(**{k: getattr(f, k) for k in (
        "path", "line", "rule", "message", "severity", "pass_name")})
        for f in ref_findings]
    assert findings_to_json(port_findings) \
        == jcore.findings_to_json(ref_findings)
    assert [f.format() for f in port_findings] \
        == [f.format() for f in ref_findings]


# ---------------------------------------------------------------------------
# the port's own fixtures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(n for n in PORT_FIXTURES
                                        if "_bad" in n))
def test_seeded_violations_found_at_marked_lines(name, tmp_manifests):
    mod = _load(name)
    expected = _seeds(mod.source)
    assert expected, f"{name} has no SEED markers"
    assert _got([mod]) == expected


@pytest.mark.parametrize("name", sorted(n for n in PORT_FIXTURES
                                        if "_clean" in n))
def test_clean_fixtures_have_zero_findings(name, tmp_manifests):
    assert run_passes([_load(name)], make_passes()) == []


def test_clean_cuda_fixture_and_its_header(tmp_manifests):
    assert run_passes(_cuda_clean(), make_passes()) == []


@pytest.mark.parametrize("edit,rule", [
    ({"cuda_clean.cu": [("  // fedlint: disable=cuda-fp32-atomic", "")]},
     "cuda-fp32-atomic"),
    ({"cuda_clean.cu": [("misaligned16(x) || misaligned16(y) || n % 4",
                         "n % 4")]}, "cuda-vector-alignment"),
    ({"cuda_clean.cuh": [("% 16 != 0", "!= 0")]}, "cuda-vector-alignment"),
    ({"cuda_clean.cu": [("x[(size_t)row * d + k]", "x[row * d + k]")]},
     "cuda-int-index"),
    ({"cuda_clean.cu": [("n, d);\n  return (int)cudaGetLastError();",
                         "n, d);\n  return 0;")]},
     "cuda-launcher-contract"),
    ({"cuda_clean.cu": [(", 0, s>>>(\n        static_cast<float*>(hist)",
                         ">>>(\n        static_cast<float*>(hist)")]},
     "cuda-launcher-contract"),
], ids=["suppression-removed", "alignment-test-removed",
        "header-test-removed", "int-product", "unchecked-launch",
        "default-stream"])
def test_each_cuda_contract_breaks_the_clean_fixture(edit, rule,
                                                     tmp_manifests):
    """One edit of the clean CUDA fixture, one rule that fires."""
    findings = run_passes(_cuda_clean(**edit), make_passes(["cuda"]))
    assert {f.rule for f in findings} == {rule}


def test_cuda_suppressions_use_slashes_and_python_ones_hashes():
    cu = Module("k.cu", "int x;  // fedlint: disable=cuda-int-index\n"
                        "// fedlint: disable-file=cuda-fp32-atomic\n"
                        "int y;  # fedlint: disable=all\n")
    assert cu.tree is None and cu.kind == "cuda"
    assert cu.line_suppressions == {1: {"cuda-int-index"}}
    assert cu.file_suppressions == {"cuda-fp32-atomic"}
    py = Module("k.py", "x = '// fedlint: disable=all'\n")
    assert py.line_suppressions == {}


def test_every_pass_and_rule_is_exercised(tmp_manifests):
    hit = []
    for name in PORT_FIXTURES:
        if "_bad" in name:
            hit += run_passes([_load(name)], make_passes())
    for name in ("fleet_loops_bad.py", "wire_decode_bad.py",
                 "obs_events_bad.py", "wire_bad.py"):
        hit += run_passes([Module(f"src/repro_torch/federated/{name}",
                                  (REF_FIXTURES / name).read_text())],
                          make_passes())
    assert {f.pass_name for f in hit} == set(available_passes())
    rules = {r for rs in rule_catalogue().values() for r in rs}
    assert {f.rule for f in hit} == rules


def test_registry_lists_the_eight_passes():
    assert available_passes() == (
        "autograd-function", "cuda", "fleet-scale", "host-sync",
        "mesh-axes", "obs-events", "wire-decode", "wire-format")
    dropped = {"host-sync-in-jit", "jit-closure-rebuild", "jit-static-args"}
    assert not dropped & set(rule_catalogue()["host-sync"])


def test_path_gates(tmp_manifests):
    """Raw timing only on the federated/core hot paths, the kernels rule
    only under kernels/, the fallback rule only in repro_torch/ outside
    tests, and CUDA sources only for the pass that reads them."""
    src = (FIXTURES / "host_sync_bad.py").read_text()
    for path in ("src/repro_torch/obs/spans.py", "tests/test_x.py",
                 "src/repro_torch/core/test_util.py"):
        assert "raw-timing-in-hot-path" not in {
            f.rule for f in run_passes([Module(path, src)],
                                       make_passes(["host-sync"]))}, path
    ksrc = (FIXTURES / "host_sync_kernels_bad.py").read_text()
    assert run_passes([Module("src/repro_torch/models/k.py", ksrc)],
                      make_passes(["host-sync"])) == []
    fsrc = (FIXTURES / "fallback_bad.py").read_text()
    assert run_passes([Module("tests/fallback.py", fsrc)],
                      make_passes(["cuda"])) == []
    cu = Module("src/repro_torch/csrc/b.cu",
                (FIXTURES / "cuda_bad.cu").read_text())
    others = [p for p in available_passes() if p != "cuda"]
    assert run_passes([cu], make_passes(others)) == []


def test_iter_files_takes_cuda_sources():
    files = iter_python_files([str(REPO_ROOT / "src" / "repro_torch")])
    suffixes = {f.suffix for f in files}
    assert suffixes == {".py", ".cu", ".cuh"}
    assert is_test_path("tests/test_torch_lint.py")


# ---------------------------------------------------------------------------
# the port's tree
# ---------------------------------------------------------------------------

def test_the_ports_tree_lints_clean():
    """The gate: ``src/repro_torch`` (csrc/ included) and chip_smoke.py,
    every pass, no finding."""
    findings = run_lint([str(REPO_ROOT / p) for p in DEFAULT_PATHS])
    assert findings == [], [f.format() for f in findings]


def test_ports_tree_carries_no_file_wide_wire_suppression():
    wire = (REPO_ROOT / "src/repro_torch/federated/wire.py").read_text()
    assert "disable-file=wire-version-stale" not in wire
    runtime = (REPO_ROOT / "src/repro_torch/federated/runtime.py")
    assert "# fedlint: disable=unchecked-wire-decode" in runtime.read_text()


# ---------------------------------------------------------------------------
# the wire manifest
# ---------------------------------------------------------------------------

def test_wire_manifest_pins_the_ports_seven_encoders():
    wire = REPO_ROOT / "src/repro_torch/federated/wire.py"
    assert run_lint([str(wire)], ["wire-format"]) == []
    manifest = json.loads(wire_checks.MANIFEST_PATH.read_text())
    encoders = [n.name for n in ast.parse(wire.read_text()).body
                if isinstance(n, ast.FunctionDef)
                and n.name.startswith("encode_")]
    assert len(encoders) == 7
    assert sorted(manifest) == sorted(f"wire.py:{n}" for n in encoders)
    assert wire_checks.MANIFEST_PATH.parent \
        == REPO_ROOT / "src/repro_torch/lint"


def test_wire_body_edit_without_version_bump_is_stale(tmp_manifests):
    src = (REF_FIXTURES / "wire_clean.py").read_text()
    wire_checks.update_manifest([str(REF_FIXTURES / "wire_clean.py")])
    edited = src.replace("len(payload)) + payload",
                         "len(payload) + 1) + payload")
    assert edited != src
    stale = [f for f in run_passes([Module("fixtures/wire_clean.py",
                                           edited)],
                                   make_passes(["wire-format"]))]
    assert [f.rule for f in stale] == ["wire-version-stale"] * 2
    assert all("bump the version" in f.message for f in stale)


def test_wire_docstring_edit_does_not_change_the_hash(tmp_manifests):
    src = (REF_FIXTURES / "wire_clean.py").read_text()
    wire_checks.update_manifest([str(REF_FIXTURES / "wire_clean.py")])
    edited = src.replace(
        "def encode_dense(payload):\n",
        'def encode_dense(payload):\n    """v1 wire header."""\n')
    assert edited != src
    assert run_passes([Module("fixtures/wire_clean.py", edited)],
                      make_passes(["wire-format"])) == []


def test_wire_hash_does_not_depend_on_type_params():
    """The hash of a FunctionDef with ``type_params`` (Python 3.12+) equals
    that of the same node without the field (Python 3.10-3.11), and a dump
    that prints every field in the 3.10 order (3.13's ``ast.dump`` drops
    empty ones)."""
    wire = REPO_ROOT / "src/repro_torch/federated/wire.py"
    for fn in wire_checks._encoders(ast.parse(wire.read_text())):
        with_field = wire_checks._encoder_hash(fn)
        fn.type_params = []
        assert wire_checks._encoder_hash(fn) == with_field
        del fn.type_params
        assert wire_checks._encoder_hash(fn) == with_field
    node = ast.parse("def f(x):\n    return x\n").body[0]
    assert wire_checks._canonical(node).startswith(
        "FunctionDef('f',arguments([],[arg('x',None,None)],None,[],[],None,"
        "[]),[Return(Name('x',Load()))],[],None,None)")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _run_cli(*args, env=ENV):
    return subprocess.run([sys.executable, "-m", "repro_torch.lint", *args],
                          capture_output=True, text=True, env=env,
                          cwd=REPO_ROOT, timeout=120)


def test_cli_exit_codes_json_and_rules():
    bad = str(FIXTURES / "vjp_bad.py")
    r = _run_cli(bad, "--select", "autograd-function")
    assert r.returncode == 1, r.stderr
    assert "[autograd-missing-backward]" in r.stdout
    assert r.stdout.strip().endswith("finding(s) from 1 pass(es)")

    r = _run_cli(str(FIXTURES / "vjp_clean.py"),
                 str(FIXTURES / "cuda_clean.cu"), "--select",
                 "autograd-function,cuda")
    assert r.returncode == 0, r.stdout

    r = _run_cli(str(FIXTURES / "cuda_bad.cu"), "--select", "cuda", "--json")
    assert r.returncode == 1
    doc = json.loads(r.stdout)
    assert doc["schema_version"] == 1 and doc["total"] > 0
    assert set(doc) == {"schema_version", "findings", "counts", "total"}
    assert {e["pass"] for e in doc["findings"]} == {"cuda"}

    r = _run_cli("--list-rules")
    assert r.returncode == 0
    for pass_name, rules in rule_catalogue().items():
        assert pass_name in r.stdout
        assert all(rule in r.stdout for rule in rules)

    assert _run_cli("no/such/path.py").returncode == 2
    assert _run_cli("--select", "bogus", ".").returncode == 2


_BLOCKED = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import repro_torch.lint, repro_torch.lint.dispatch
from repro_torch.lint.__main__ import main
rc = main([])
print("rc", rc)
"""


def test_lint_and_its_cli_run_without_jax_or_the_reference():
    """``import repro_torch.lint`` and ``python -m repro_torch.lint`` with
    its default paths, from the repo's root, with jax and the JAX package
    blocked from import: the tree lints clean."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED], env=ENV,
                         cwd=REPO_ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-1500:]
    assert out.stdout.strip().endswith(
        "0 finding(s) from 8 pass(es)\nrc 0"), out.stdout[-1500:]


# ---------------------------------------------------------------------------
# dispatch helpers
# ---------------------------------------------------------------------------

def _syncing(x):
    a = x.sum().item()
    b = float(x.max())
    if x.min() < 0:
        a += b
    nz = x.nonzero()
    picked = x[x > 0]
    return a, nz, picked


def test_host_syncs_name_op_and_line():
    x = torch.randn(6, generator=torch.Generator().manual_seed(0))
    syncs = dispatch.host_syncs(_syncing, x)
    first = _syncing.__code__.co_firstlineno
    here = "tests/test_torch_lint.py"
    assert syncs == [
        ("aten._local_scalar_dense", f"{here}:{first + 1}"),
        ("aten._local_scalar_dense", f"{here}:{first + 2}"),
        ("aten._local_scalar_dense", f"{here}:{first + 3}"),
        ("aten.nonzero (data-dependent shape)", f"{here}:{first + 5}"),
        ("aten.index (boolean mask)", f"{here}:{first + 6}"),
    ]
    assert dispatch.host_syncs(lambda t: t * 2, x) == []
    assert dispatch.copies_to_host(syncs) == []


def test_one_femnist_step_syncs_on_the_cpu():
    """One FedLite step of FemnistCNN on the CPU (the plain versions):
    the only syncs are the two range checks of ``F.one_hot`` in the plain
    ``lloyd_update_ref``, once per Lloyd iteration; the step's own code
    makes none. On the card the kernel takes its place (chip_smoke.py's
    lint phase lists that path's syncs)."""
    from repro_torch.core.fedlite import TrainState, make_train_step
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import sgd

    iters = 2
    model = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=iters), lam=1e-4,
                       client_batch=4, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    state = TrainState.create(dict(model.named_parameters()), sgd(0.03))
    data = make_federated_image_data(num_clients=8, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    parts = [data.sample_batch(c, rng, 4) for c in range(3)]
    batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    syncs = dispatch.host_syncs(make_train_step(model, sgd(0.03)),
                                state, batch)
    assert [s.op for s in syncs] == ["aten._local_scalar_dense"] * 2 * iters
    ref = REPO_ROOT / "src/repro_torch/kernels/ref.py"
    lines = ref.read_text().splitlines()
    for s in syncs:
        path, line = s.where.rsplit(":", 1)
        assert path == "src/repro_torch/kernels/ref.py"
        assert "F.one_hot" in lines[int(line) - 1]


def test_collectives_map_to_the_clients_dimension():
    """Eager ``dist.all_reduce`` shows up under the dispatch mode (as
    ``c10d.allreduce_``, the process group an argument), so the real mesh
    step's one all-reduce maps to ``clients``; a group of no dimension is
    reported as undeclared."""
    from repro_torch.core.fedlite import TrainState, make_mesh_step
    from repro_torch.core.quantizer import PQConfig
    from repro_torch.data.synthetic import make_federated_image_data
    from repro_torch.launch.mesh import make_clients_mesh
    from repro_torch.models.paper_models import FemnistCNN
    from repro_torch.optim import sgd

    mesh = make_clients_mesh(1, "cpu")
    t = torch.ones(3)
    group = mesh.get_group("clients")
    assert dispatch.collective_group_names(
        lambda: dist.all_reduce(t, group=group), mesh) == {"clients"}
    assert dispatch.collective_group_names(lambda: t * 2, mesh) == set()

    model = FemnistCNN(pq=PQConfig(1152, 2, kmeans_iters=1), lam=1e-4,
                       client_batch=4, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    state = TrainState.create(dict(model.named_parameters()), sgd(0.03))
    data = make_federated_image_data(num_clients=4, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    batches = [data.sample_batch(c, rng, 4) for c in range(2)]
    step = make_mesh_step(model, sgd(0.03), mesh)
    assert dispatch.collective_group_names(
        step, mesh, state, batches, [0.5, 0.5], [1.0, 1.0]) == {"clients"}

    other = dist.new_group([0])
    assert dispatch.undeclared_collective_groups(
        lambda: dist.all_reduce(t, group=other), mesh) \
        == {f"<group {other.group_name}>"}


class _Good(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, codes):
        return x * k

    @staticmethod
    def backward(ctx, g):
        return g * 2, None, None


class _Invents(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, codes):
        return x * k

    @staticmethod
    def backward(ctx, g):
        return g * 2, None, torch.ones_like(g)


class _Short(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, codes):
        return x * k

    @staticmethod
    def backward(ctx, g):
        return (g * 2,)


def test_integer_gradient_violations():
    x, codes = torch.ones(3), torch.arange(3)
    assert dispatch.integer_gradient_violations(
        lambda a, c: _Good.apply(a, 2.0, c), x, codes) == []
    assert dispatch.integer_gradient_violations(
        lambda a, c: _Invents.apply(a, 2.0, c), x, codes) \
        == [("_Invents", 2)]
    with pytest.raises(RuntimeError, match="incorrect number of gradients"):
        dispatch.integer_gradient_violations(
            lambda a, c: _Short.apply(a, 2.0, c), x, codes)
    # the patched apply is put back whatever happened
    assert torch.autograd.Function.__dict__["apply"].__func__ \
        is not None and _Good.apply(x, 2.0, codes).shape == (3,)


def test_the_ports_functions_give_integer_inputs_no_gradient():
    """The port's uplink hook with an integer λ step index beside it: the
    eq.-5 Function returns None for λ and the config."""
    from repro_torch.core.correction import quantize_with_correction
    from repro_torch.core.quantizer import PQConfig

    cfg = PQConfig(4, 2, kmeans_iters=2, backend="torch")
    z = torch.randn(1, 6, 8, generator=torch.Generator().manual_seed(0))
    lam = torch.tensor(3, dtype=torch.int32)
    assert dispatch.integer_gradient_violations(
        lambda a, l: quantize_with_correction(a, l, cfg), z, lam) == []
