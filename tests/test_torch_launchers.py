"""The port's launchers on the CPU (twins of tests/test_launchers.py):
``python -m repro_torch.launch.train --smoke --device cpu`` for a dense and
an audio architecture, its checkpoint restored by the JAX package, the
training loop against the reference's step on the same params and
batches, and ``launch.serve`` of the SSM architecture.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import restore_checkpoint as jrestore
from repro.checkpointing import save_checkpoint as jsave
from repro.configs import base as jbase
from repro.core import fedlite as jfed
from repro.launch.specs import make_model as jmake_model
from repro.optim import get_optimizer as jget_optimizer
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.configs import base as tbase
from repro_torch.launch import train as ttrain

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))


def _run(args, timeout=300):
    return subprocess.run([sys.executable, "-m"] + args, env=ENV, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_train_cli_dense(tmp_path):
    """3 steps of the Llama-3 smoke model with a checkpoint at step 3: the
    reference's lines, and a checkpoint the reference restores with the
    port's params' keys, shapes and dtypes."""
    p = _run(["repro_torch.launch.train", "--arch", "llama3_8b", "--smoke",
              "--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
              "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert p.returncode == 0, p.stderr[-1500:]
    assert "uplink compression" in p.stdout and "done" in p.stdout
    assert "step     2  loss=" in p.stdout
    assert any(f.startswith("ckpt_") for f in os.listdir(tmp_path))
    tree = jrestore(str(tmp_path), 3)["params"]
    cfg = jbase.get_arch("llama3_8b", smoke=True)
    shapes = jax.eval_shape(jmake_model(cfg).init, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), tree) == \
        jax.tree.map(lambda s: (s.shape, str(s.dtype)), shapes)
    # and the port resumes from it
    p = _run(["repro_torch.launch.train", "--arch", "llama3_8b", "--smoke",
              "--device", "cpu", "--steps", "4", "--batch", "2", "--seq",
              "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3"])
    assert p.returncode == 0, p.stderr[-1500:]
    assert "resumed from step 3" in p.stdout and "step     3  " in p.stdout


def test_train_cli_audio():
    p = _run(["repro_torch.launch.train", "--arch", "musicgen_large",
              "--smoke", "--device", "cpu", "--steps", "2", "--batch", "2",
              "--seq", "16"])
    assert p.returncode == 0, p.stderr[-1500:]
    assert "done" in p.stdout


def test_serve_cli_ssm():
    p = _run(["repro_torch.launch.serve", "--arch", "mamba2_1p3b",
              "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
              "16", "--gen", "3"])
    assert p.returncode == 0, p.stderr[-1500:]
    assert "decode:" in p.stdout


@pytest.mark.parametrize("arch", ["qwen2_vl_2b", "mixtral_8x22b"])
def test_train_loop_matches_reference_steps(tmp_path, arch):
    """``train(cfg, args)`` resumed from the reference's params (saved by
    the reference at step 0) and fed the launcher's batches: each step's
    loss within rtol 1e-5 of the reference's ``make_train_step`` under the
    launcher's optimizer (Adam with --smoke, ``warmup_cosine(lr, 10,
    steps)``), SplitFed."""
    jcfg = jbase.get_arch(arch, smoke=True)
    jmodel = jmake_model(jcfg, with_pq=False)
    jp = jmodel.init(jax.random.PRNGKey(0))
    jsave(str(tmp_path), 0, {"params": jp})
    args = ttrain.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                              "--steps", "3", "--batch", "2", "--seq", "16",
                              "--no-pq", "--ckpt-dir", str(tmp_path)])
    lines = []
    _, hist = ttrain.train(tbase.get_arch(arch, smoke=True), args,
                           log=lines.append)
    assert lines[0] == "resumed from step 0" and lines[-1] == "done"

    opt = jget_optimizer("adam", jwarmup_cosine(args.lr, 10, args.steps))
    step = jfed.make_train_step(jmodel, opt, quantize=False, donate=False)
    state = jfed.TrainState.create(jp, opt)
    for s in range(3):
        tb = ttrain.make_batch(tbase.get_arch(arch, smoke=True),
                               ttrain.step_rng(args.seed, s), 2, 16, "cpu")
        state, m = step(state, {
            k: jnp.asarray(v.numpy().astype(
                np.float32 if v.dtype == torch.float32 else np.int32))
            for k, v in tb.items()})
        np.testing.assert_allclose(float(hist[s]["loss"]), float(m["loss"]),
                                   rtol=1e-5)
        assert hist[s]["seconds"] > 0


@pytest.mark.parametrize("launcher", ["train", "serve"])
def test_launcher_mesh_on_a_world_of_one_exits_with_the_mesh_error(launcher):
    """``--mesh single`` on a world of one: the launcher exits through the
    production mesh's error, naming the 256 ranks it needs; it does not
    fall back to ``--mesh none``."""
    from repro_torch.launch import serve as tserve
    main = ttrain.main if launcher == "train" else tserve.main
    with pytest.raises(SystemExit, match="need 256 ranks"):
        main(["--arch", "llama3_8b", "--smoke", "--device", "cpu",
              "--mesh", "single"])


_BLOCKED = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import repro_torch.models.moe, repro_torch.models.ssm
from repro_torch.configs import ARCH_IDS, get_arch
for arch in ARCH_IDS:
    get_arch(arch), get_arch(arch, smoke=True)
from repro_torch.launch import train
train.main(["--arch", "jamba_v0p1_52b", "--smoke", "--device", "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16"])
"""


def test_lm_modules_run_without_jax_or_the_reference():
    """The new modules, the ten configs and a hybrid MoE / SSM training
    step, with jax and the JAX package blocked from import."""
    out = subprocess.run([sys.executable, "-c", _BLOCKED], env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-1500:]
    assert out.stdout.strip().endswith("done")
