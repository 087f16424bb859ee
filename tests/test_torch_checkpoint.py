"""The port's checkpointing (``repro_torch/checkpointing``) against the JAX
package's, on the CPU.

Twins of ``tests/test_checkpoint.py`` (the four rejections of a corrupt
step are cases of one test), then the format itself: the npz member names,
the meta json and the manifest keys equal the reference's for the same
tree, and a step written by either package restores through the other
bitwise, bf16 included. Every comparison here is bitwise.
"""

import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import restore_checkpoint as j_restore
from repro.checkpointing import save_checkpoint as j_save
from repro_torch import obs
from repro_torch.checkpointing import (CheckpointError, latest_step,
                                       restore_checkpoint, save_checkpoint,
                                       verify_checkpoint)

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _restore(path, step=None):
    return restore_checkpoint(str(path), step, device="cpu")


def test_roundtrip(tmp_path):
    tree = {"a": {"b": torch.arange(6.0).reshape(2, 3)},
            "c": torch.ones(4, dtype=torch.bfloat16),
            "step": np.asarray(7, np.int32)}
    save_checkpoint(str(tmp_path), 7, tree, extra={"loss": 1.0})
    assert latest_step(str(tmp_path)) == 7
    back = _restore(tmp_path)
    assert torch.equal(back["a"]["b"], tree["a"]["b"])
    assert back["c"].dtype == torch.bfloat16
    assert torch.equal(back["c"], tree["c"])
    assert back["step"].dtype == torch.int32 and int(back["step"]) == 7


def test_multiple_steps_latest_wins(tmp_path):
    for s in (1, 5, 3):
        save_checkpoint(str(tmp_path), s, {"x": torch.tensor(float(s))})
    assert latest_step(str(tmp_path)) == 5
    assert float(_restore(tmp_path)["x"]) == 5.0


# ---------------------------------------------------------------------------
# crash consistency
# ---------------------------------------------------------------------------

def _ckpt(tmp_path, step, value):
    return save_checkpoint(str(tmp_path), step, {"x": torch.tensor(value)},
                           extra={"v": value})


def test_crash_before_manifest_leaves_step_invisible(tmp_path):
    """Crash after the npz rename but before the manifest: the step was
    never committed — latest_step must keep returning the previous one."""
    _ckpt(tmp_path, 1, 1.0)
    _ckpt(tmp_path, 2, 2.0)
    os.remove(os.path.join(tmp_path, "manifest_00000002.json"))
    assert latest_step(str(tmp_path)) == 1
    assert float(_restore(tmp_path)["x"]) == 1.0


def test_crash_mid_npz_leaves_only_the_tmp_file(tmp_path):
    with open(os.path.join(tmp_path, "ckpt_00000003.npz.tmp.npz"), "wb") as f:
        f.write(b"half a zip")
    assert latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        _restore(tmp_path)


def _truncate(tmp_path, path, step):
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:len(data) // 2])
    return lambda: _restore(tmp_path, step)


def _remove(tmp_path, path, step):
    os.remove(path)
    return lambda: verify_checkpoint(str(tmp_path), step)


def _garble_manifest(tmp_path, path, step):
    with open(os.path.join(tmp_path, f"manifest_{step:08d}.json"), "w") as f:
        f.write("{not json")
    return lambda: _restore(tmp_path, step)


def _edit_meta(tmp_path, path, step):
    mpath = os.path.join(tmp_path, f"meta_{step:08d}.json")
    meta = json.load(open(mpath))
    meta["v"] = 999.0
    with open(mpath, "w") as f:
        json.dump(meta, f)
    return lambda: verify_checkpoint(str(tmp_path), step)


@pytest.mark.parametrize("damage,match", [
    (_truncate, "checksum mismatch"),          # torn write after commit
    (_remove, "missing file"),                 # payload gone
    (_garble_manifest, "unreadable manifest"),
    (_edit_meta, "checksum mismatch"),         # the meta json is covered too
], ids=["truncated_payload", "missing_payload", "corrupt_manifest",
        "meta_json"])
def test_damaged_step_behind_a_manifest_is_rejected(tmp_path, damage, match):
    path = _ckpt(tmp_path, 4, 4.0)
    check = damage(tmp_path, path, 4)
    with pytest.raises(CheckpointError, match=match):
        check()


def test_legacy_bare_npz_still_restores(tmp_path):
    path = _ckpt(tmp_path, 8, 8.0)
    os.remove(os.path.join(tmp_path, "manifest_00000008.json"))
    os.rename(path, os.path.join(tmp_path, "ckpt_00000009.npz"))
    assert latest_step(str(tmp_path)) == 9
    assert float(_restore(tmp_path)["x"]) == 8.0


def test_manifest_steps_take_priority_over_bare_npz(tmp_path):
    _ckpt(tmp_path, 1, 1.0)
    with open(os.path.join(tmp_path, "ckpt_00000099.npz"), "wb") as f:
        f.write(b"garbage")
    assert latest_step(str(tmp_path)) == 1


def test_train_state_roundtrip(tmp_path):
    from repro_torch.core.fedlite import TrainState
    from repro_torch.models.paper_models import SOTagMLP
    from repro_torch.optim import adagrad
    model = SOTagMLP(bow_dim=64, cut_dim=32, num_tags=16, device=CPU)
    state = TrainState.create(dict(model.named_parameters()), adagrad(0.1))
    save_checkpoint(str(tmp_path), 0, {"params": state.params,
                                       "opt": state.opt_state})
    back = _restore(tmp_path, 0)
    for k, v in state.params.items():
        assert torch.equal(back["params"][k], v)
    for k, v in state.opt_state["acc"].items():
        assert torch.equal(back["opt"]["acc"][k], v)
    assert int(back["opt"]["step"]) == 0


# ---------------------------------------------------------------------------
# the port's own contract
# ---------------------------------------------------------------------------

def test_restore_needs_a_card_unless_asked_for_the_cpu(tmp_path,
                                                       monkeypatch):
    _ckpt(tmp_path, 1, 1.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(str(tmp_path))
    assert float(restore_checkpoint(str(tmp_path), device="cpu")["x"]) == 1.0


def test_save_and_restore_record_their_spans(tmp_path):
    rec = obs.configure(run="ckpt")
    try:
        _ckpt(tmp_path, 2, 2.0)
        _restore(tmp_path)
    finally:
        obs.shutdown()
    names = [e["name"] for e in rec.events if e["type"] == "span"]
    assert names == ["checkpoint.save", "checkpoint.restore"]


# ---------------------------------------------------------------------------
# the format, across the packages
# ---------------------------------------------------------------------------

def _trees(seed=0):
    """The same tree for each package: f32, bf16, int32 leaves, 0-d and
    nested."""
    r = np.random.default_rng(seed)
    f32 = r.standard_normal((3, 5)).astype(np.float32)
    bf16 = r.standard_normal((7,)).astype(np.float32)
    ints = r.integers(-9, 9, (2, 2)).astype(np.int32)
    jt = {"train": {"0000": jnp.asarray(f32),
                    "0001": jnp.asarray(bf16, jnp.bfloat16),
                    "0002": jnp.asarray(4, jnp.int32)},
          "ef": {"3": jnp.asarray(ints)}}
    tt = {"train": {"0000": torch.from_numpy(f32),
                    "0001": torch.from_numpy(bf16).to(torch.bfloat16),
                    "0002": np.asarray(4, np.int32)},
          "ef": {"3": torch.from_numpy(ints)}}
    return jt, tt


def _members(path):
    with zipfile.ZipFile(path) as z:
        return sorted(z.namelist())


def test_format_names_equal_the_reference(tmp_path):
    jt, tt = _trees()
    extra = {"cursor": {"round": 3, "t": np.float64(1.5)}, "n": np.int64(2)}
    jp = j_save(str(tmp_path / "j"), 3, jt, extra=extra)
    tp = save_checkpoint(str(tmp_path / "t"), 3, tt, extra=extra)
    assert os.path.basename(jp) == os.path.basename(tp) == \
        "ckpt_00000003.npz"
    assert _members(jp) == _members(tp)
    assert "__dtype__train/0001.npy" in _members(tp)
    assert sorted(os.listdir(tmp_path / "j")) == \
        sorted(os.listdir(tmp_path / "t"))
    jm = json.load(open(tmp_path / "j" / "manifest_00000003.json"))
    tm = json.load(open(tmp_path / "t" / "manifest_00000003.json"))
    assert jm.keys() == tm.keys() and jm["step"] == tm["step"]
    assert sorted(jm["files"]) == sorted(tm["files"])
    # the meta json is byte for byte the reference's
    assert jm["files"]["meta_00000003.json"] == \
        tm["files"]["meta_00000003.json"]
    with np.load(jp) as zj, np.load(tp) as zt:
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
            np.testing.assert_array_equal(zj[k], zt[k])


def test_reference_step_restores_through_the_port_bitwise(tmp_path):
    jt, _ = _trees(1)
    j_save(str(tmp_path), 5, jt, extra={"v": 1})
    back = _restore(tmp_path)
    assert back["train"]["0001"].dtype == torch.bfloat16
    for k, v in jt["train"].items():
        got = back["train"][k]
        if v.dtype == jnp.bfloat16:
            got, v = got.view(torch.int16), np.asarray(v).view(np.int16)
        np.testing.assert_array_equal(got.numpy(), np.asarray(v))
    np.testing.assert_array_equal(back["ef"]["3"].numpy(),
                                  np.asarray(jt["ef"]["3"]))


def test_port_step_restores_through_the_reference_bitwise(tmp_path):
    _, tt = _trees(2)
    save_checkpoint(str(tmp_path), 6, tt, extra={"v": 1})
    back = j_restore(str(tmp_path))
    assert back["train"]["0001"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["train"]["0001"]).view(np.int16),
        tt["train"]["0001"].view(torch.int16).numpy())
    np.testing.assert_array_equal(np.asarray(back["train"]["0000"]),
                                  tt["train"]["0000"].numpy())
    assert back["train"]["0002"].dtype == jnp.int32 \
        and int(back["train"]["0002"]) == 4
    np.testing.assert_array_equal(np.asarray(back["ef"]["3"]),
                                  tt["ef"]["3"].numpy())
    jax.tree.map(lambda x: x.block_until_ready(), back)


_BLOCKED = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import repro_torch.checkpointing, repro_torch.federated.recovery
import repro_torch.federated.autoscale, repro_torch.obs.slo
import repro_torch.obs.schema, repro_torch.obs.inspect, repro_torch.obs
import repro_torch.federated
print("ok")
"""


def test_new_modules_import_without_jax_or_the_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _BLOCKED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
