"""The four examples' twins (``repro_torch.examples``) against the
reference's ``examples/*.py``, on the CPU.

Each reference example runs unedited, in process, through ``runpy`` with
``sys.argv`` patched; its twin runs through ``main(argv)`` with the same
small argv and ``--device cpu``. Lines that do not depend on the framework
(compression ratios, the ideal loop's analytic uplink, measured wire
bytes, simulated wall-clock, stragglers dropped, the uplink of a served
prompt) are equal character for character; every other line has the same
fields (the text with its numbers blanked) and finite values. The FEMNIST
twin's trainer is also held to the reference's field by field, as both
build it from one argv.
"""

import dataclasses
import math
import re
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.federated as jfederated
from repro_torch.examples import (femnist_federated_training, quickstart,
                                  serve_split, split_llm_finetune)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
# lines (by a piece of their text) that must be equal character for
# character, and fields of other lines that must be
EXACT_LINES = ("compression ratio", "corrected cotangent",
               "activation compression", "simulated wall-clock",
               "measured uplink", "measured downlink", "stragglers dropped",
               "mean staleness", "uplink per client", "(reduced): client")
EXACT_FIELDS = (re.compile(r"uplink=\s*[\d.]+ MB"),)
FEMNIST_ARGVS = [
    ["--rounds", "2"],
    ["--fleet", "mobile", "--policy", "deadline", "--rounds", "2"],
    ["--downlink", "chain:topk(k=0.1)+scalarq(bits=8)", "--fleet",
     "lognormal", "--rounds", "2"],
]


def _reference(name, argv, monkeypatch, capsys):
    """The reference example's standard output, run as a script."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    capsys.readouterr()
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


def _twin(module, argv, capsys):
    capsys.readouterr()
    assert module.main([*argv, "--device", "cpu"]) == 0
    return capsys.readouterr().out


def _shape(line):
    """The line with its numbers blanked and its runs of blanks as one."""
    return NUM.sub("#", re.sub(r"\s+", " ", line).replace("[ ", "["))


def _hold(ours, ref, differs=()):
    """Line by line, as the module docstring says; a line containing one
    of ``differs`` (old, new) compares after ``old`` becomes ``new`` in
    the reference's."""
    ours, ref = ours.strip().splitlines(), ref.strip().splitlines()
    assert len(ours) == len(ref), (ours, ref)
    for a, b in zip(ours, ref):
        for old, new in differs:
            b = b.replace(old, new)
        if any(key in b for key in EXACT_LINES):
            assert a == b
            continue
        assert _shape(a) == _shape(b), (a, b)
        assert all(math.isfinite(float(v)) for v in NUM.findall(a)), a
        for field in EXACT_FIELDS:
            assert field.findall(a) == field.findall(b), (a, b)


def test_quickstart_matches_reference(monkeypatch, capsys):
    ref = _reference("quickstart", [], monkeypatch, capsys)
    ours = _twin(quickstart, [], capsys)
    _hold(ours, ref)
    assert "490.2x" in ours and ": True" in ours


@pytest.mark.parametrize("argv", FEMNIST_ARGVS,
                         ids=["ideal", "deadline", "downlink"])
def test_femnist_example_matches_reference(argv, monkeypatch, capsys):
    ref = _reference("femnist_federated_training", argv, monkeypatch,
                     capsys)
    ours = _twin(femnist_federated_training, argv, capsys)
    _hold(ours, ref)


def test_split_llm_finetune_matches_reference(monkeypatch, capsys):
    argv = ["--steps", "2", "--batch", "2", "--seq", "16"]
    ref = _reference("split_llm_finetune", argv, monkeypatch, capsys)
    ours = _twin(split_llm_finetune, argv, capsys)
    _hold(ours, ref)


def test_serve_split_matches_reference(monkeypatch, capsys):
    argv = ["--arch", "mamba2_1p3b", "--prompt-len", "16", "--gen", "3",
            "--batch", "2"]
    ref = _reference("serve_split", argv, monkeypatch, capsys)
    ours = _twin(serve_split, argv, capsys)
    _hold(ours, ref, differs=(("on CPU, untuned", "on CPU"),))


# ---------------------------------------------------------------------------
# the FEMNIST example's trainer, field by field
# ---------------------------------------------------------------------------

class _Built(Exception):
    """Raised by a recording stand-in for FederatedTrainer: the run stops
    where its trainer is built."""


def _recording(store):
    def build(model, optimizer, data, **kw):
        store.update(kw, model=model, optimizer=optimizer, data=data)
        raise _Built
    return build


def _plain(value):
    """A value as builtins, for comparing the two packages' objects field
    by field (dataclasses by their fields, arrays and tensors by value,
    other objects by their class name and attributes)."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if torch.is_tensor(value):
        return value.detach().cpu().numpy().tolist()
    if isinstance(value, (np.ndarray, np.generic)) or \
            type(value).__module__.startswith("jax"):
        return np.asarray(value).tolist()
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return {"class": type(value).__name__,
            **{k: _plain(v) for k, v in vars(value).items()}}


TRAINER_ARGVS = [
    ["--rounds", "2"],
    ["--fleet", "mobile", "--policy", "deadline", "--warm-start",
     "--delta-bits", "4", "--chaos", "--q", "96", "--clusters", "4"],
    ["--downlink", "chain:topk(k=0.1)+scalarq(bits=8)", "--fleet",
     "lognormal", "--policy", "drop2", "--baseline", "--cohort", "6",
     "--client-batch", "10", "--lam", "0.001"],
    ["--autoscale", "--fleet", "mobile", "--policy", "async"],
]


@pytest.mark.parametrize("argv", TRAINER_ARGVS,
                         ids=["ideal", "chaos", "baseline", "autoscale"])
def test_femnist_example_builds_the_references_trainer(argv, tmp_path,
                                                       monkeypatch, capsys):
    """The twin's FederatedTrainer and the reference's, from one argv (with
    --emit-trace, which adds the SLO monitor): every argument equal (the
    model's codec settings, the optimizer's update, the dataset's client
    weights, the fleet, policy and fault plan field by field), the twin's
    ``device`` beside them."""
    argv = [*argv, "--emit-trace", str(tmp_path / "t.jsonl")]
    ref, ours = {}, {}
    monkeypatch.setattr(jfederated, "FederatedTrainer", _recording(ref))
    with pytest.raises(_Built):
        _reference("femnist_federated_training", argv, monkeypatch, capsys)
    monkeypatch.setattr(femnist_federated_training, "FederatedTrainer",
                        _recording(ours))
    with pytest.raises(_Built):
        femnist_federated_training.main([*argv, "--device", "cpu"])
    for module in ("repro.obs", "repro_torch.obs"):
        sys.modules[module].shutdown()
    assert ours.pop("device") == torch.device("cpu")
    assert ours.keys() == ref.keys()
    jm, tm = ref.pop("model"), ours.pop("model")
    for field in ("pq", "lam", "client_batch", "num_classes"):
        assert _plain(getattr(tm, field)) == _plain(getattr(jm, field)), \
            field
    jo, to = ref.pop("optimizer"), ours.pop("optimizer")
    assert to.name == jo.name == "sgd"
    ju, _ = jo.update({"w": np.ones(3, np.float32)}, jo.init({}), None)
    tu, _ = to.update({"w": torch.ones(3)}, to.init({}), None)
    np.testing.assert_array_equal(tu["w"].numpy(), np.asarray(ju["w"]))
    jd, td = ref.pop("data"), ours.pop("data")
    assert td.num_clients == jd.num_clients
    np.testing.assert_array_equal(td.client_weights, jd.client_weights)
    for key in ref:
        assert _plain(ours[key]) == _plain(ref[key]), key


def test_femnist_example_mesh_executor_names_the_roadmap(monkeypatch,
                                                         capsys):
    """``--executor mesh`` runs the scheduled loop on the mesh executor (a
    world of one when launched plainly; the reference needs several JAX
    devices for it): its round is the same round of the stacked trainer
    built from the same argv, within the reference's stacked-vs-mesh
    bounds, with the same trace record but the executor."""
    fx = femnist_federated_training
    built, cls = [], fx.FederatedTrainer
    monkeypatch.setattr(fx, "FederatedTrainer",
                        lambda *a, **kw: built.append(cls(*a, **kw))
                        or built[-1])
    argv = ["--rounds", "1", "--cohort", "3", "--executor", "mesh"]
    out = _twin(fx, argv, capsys)
    assert "fleet=ideal policy=full_sync  rounds=1" in out
    (mesh,) = built
    assert mesh.last_trace.meta["executor"] == "mesh"
    stacked = fx.build(fx.parse_args([*argv[:-1], "stacked", "--device",
                                      "cpu"]))[3](3, fx.FullSync(), None)
    assert stacked.executor.name == "stacked"
    stacked.run(1, 0)
    ours, theirs = mesh.last_trace.records[0], stacked.last_trace.records[0]
    np.testing.assert_allclose(ours.metrics["loss"], theirs.metrics["loss"],
                               rtol=5e-4)
    assert dataclasses.replace(ours, metrics={}) == \
        dataclasses.replace(theirs, metrics={})
