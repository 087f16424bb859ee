"""The port's sharding rules and context (``repro_torch/sharding``) against
the JAX package's.

  * twins of tests/test_sharding.py's eight cases, on the port's
    ``AbstractMesh`` (axis names and sizes, no ranks);
  * spec parity: for every param path of all ten archs' published configs
    (shapes from a meta-device init and the reference's ``eval_shape``),
    ``spec_for_param`` and ``inference_spec`` equal the reference's entry
    for entry on (4, 2), (16, 16) and (2, 16, 16) meshes (the reference on
    tests/test_sharding.py's repeated-device ``Mesh``);
  * layout parity: for specs with multi-axis entries, the block each of 4
    ranks holds under ``to_placements`` (DTensor's own shard arithmetic)
    equals ``NamedSharding.devices_indices_map`` of the reference on a
    (2, 2) mesh of 4 host devices (a subprocess with XLA_FLAGS);
  * ``local`` passes plain tensors straight through without a mesh, and
    ``named_sharding`` places the reference's spec on the installed mesh.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro.configs.base import ARCH_IDS
from repro.configs.base import get_arch as j_get_arch
from repro.launch.specs import make_model as j_make_model
from repro.sharding.rules import inference_spec as j_inference_spec
from repro.sharding.rules import spec_for_param as j_spec_for_param
from repro_torch.configs.base import get_arch
from repro_torch.core.fedlite import flat_params
from repro_torch.launch.specs import make_model
from repro_torch.sharding import ctx
from repro_torch.sharding.ctx import (AbstractMesh, P, current_mesh,
                                      filter_spec, local, set_mesh, shard,
                                      shard_residual, to_placements,
                                      use_mesh)
from repro_torch.sharding.rules import (inference_spec, param_specs,
                                        spec_for_param)

MESH = AbstractMesh((4, 2), ("data", "model"))
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def test_spec_rules_basic():
    assert spec_for_param("client/layers/p0/mixer/wq", (1, 512, 256), MESH) \
        == P(None, "data", "model")
    assert spec_for_param("server/layers/p0/mixer/wo", (1, 256, 512), MESH) \
        == P(None, "model", "data")
    assert spec_for_param("client/tok_embed", (50304, 512), MESH) \
        == P(None, "data")
    assert spec_for_param("server/head", (512, 50304), MESH) \
        == P("data", "model")
    assert spec_for_param("server/layers/p0/ln1/scale", (1, 512), MESH) \
        == P()  # replicated (P() == all-None)


def test_expert_rule_divisibility():
    # E=4 divides model=2 -> expert parallel
    assert spec_for_param("s/layers/p0/ffn/we_up", (1, 4, 256, 512), MESH) \
        == P(None, "model", "data", None)
    # E=3 does not -> Megatron TP inside each expert (+ FSDP over data)
    assert spec_for_param("s/layers/p0/ffn/we_up", (1, 3, 256, 512), MESH) \
        == P(None, None, "data", "model")
    assert spec_for_param("s/layers/p0/ffn/we_down", (1, 3, 512, 256),
                          MESH) == P(None, None, "model", "data")


def test_divisibility_guard_drops_axis():
    # dim 6 not divisible by data=4 -> replicated on that dim
    assert spec_for_param("x/head", (6, 50304), MESH) == P(None, "model")


def test_filter_spec_drops_missing_axes():
    assert filter_spec(P(("pod", "data"), None), MESH) == P("data", None)
    assert filter_spec(P("pod", "model"), MESH) == P(None, "model")


def test_param_specs_walks_opt_state_shapes():
    tree = {"m": {"client": {"layers": {"p0": {"mixer": {
        "wq": torch.zeros((2, 512, 256))}}}}},
        "step": torch.zeros(())}
    specs = param_specs(tree, MESH)
    assert specs["m"]["client"]["layers"]["p0"]["mixer"]["wq"] == \
        P(None, "data", "model")
    assert specs["step"] == P()


def test_shard_noop_without_mesh():
    assert current_mesh() is None
    x = torch.ones((4, 4))
    assert shard(x, "data", None) is x
    z = shard_residual(torch.ones((2, 3, 4)))
    assert z.shape == (2, 3, 4)


def test_use_mesh_restores():
    with use_mesh(MESH):
        assert current_mesh() is MESH
    assert current_mesh() is None
    set_mesh(None)


def test_inference_spec_folds_data_into_tp():
    # column weight (512, 256): data on dim0 folds into dim1's TP group
    assert inference_spec(P("data", "model"), (512, 256), MESH) \
        == P(None, ("model", "data"))
    # row weight
    assert inference_spec(P("model", "data"), (512, 256), MESH) \
        == P(("model", "data"), None)
    # non-divisible merged axis -> unchanged
    assert inference_spec(P("data", "model"), (512, 6), MESH) \
        == P("data", "model")
    # no model dim -> unchanged (e.g. embeddings)
    assert inference_spec(P(None, "data"), (50304, 512), MESH) \
        == P(None, "data")


def test_local_without_a_mesh_is_the_function():
    x = torch.randn(3, 4)
    out = local(lambda t: t * 2, P("data"), (P("data"),))(x)
    assert torch.equal(out, x * 2)


# ---------------------------------------------------------------------------
# spec parity with the reference on every param of the ten published configs
# ---------------------------------------------------------------------------

def _jax_mesh(shape, names):
    devs = np.array(jax.devices() * int(np.prod(shape)))[:int(np.prod(shape))]
    return Mesh(devs.reshape(shape), names)


def _norm(spec) -> tuple:
    """A spec as a tuple of entries (names tuples or None), trailing Nones
    dropped: the reference's PartitionSpec and the port's P alike."""
    out = []
    for e in spec:
        if e is None:
            out.append(None)
        elif isinstance(e, str):
            out.append((e,))
        else:
            out.append(tuple(e) or None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.fixture(scope="module")
def shapes():
    """{arch: {path: shape}} from the port's meta init and the
    reference's eval_shape (equal, path for path)."""
    out = {}
    for arch in ARCH_IDS:
        port = {k: tuple(v.shape) for k, v in flat_params(
            make_model(get_arch(arch)).init(None, "meta")).items()}
        ref = jax.eval_shape(j_make_model(j_get_arch(arch)).init,
                             jax.random.PRNGKey(0))
        ref = {"/".join(str(getattr(k, "key", k)) for k in path):
               tuple(leaf.shape) for path, leaf in
               jax.tree_util.tree_flatten_with_path(ref)[0]}
        assert port == ref, arch
        out[arch] = port
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_param_and_inference_spec_match_the_reference(shapes, mesh):
    shape, names = MESHES[mesh]
    pm, jm = AbstractMesh(shape, names), _jax_mesh(shape, names)
    n = 0
    for arch, leaves in shapes.items():
        for path, shp in leaves.items():
            sp, jsp = spec_for_param(path, shp, pm), \
                j_spec_for_param(path, shp, jm)
            assert _norm(sp) == _norm(jsp), (arch, path, shp, sp, jsp)
            isp = inference_spec(sp, shp, pm)
            jisp = j_inference_spec(jsp, shp, jm)
            assert _norm(isp) == _norm(jisp), (arch, path, shp, isp, jisp)
            n += 1
    assert n == sum(len(v) for v in shapes.values()) > 500


# ---------------------------------------------------------------------------
# layout parity: the block of every rank on a (2, 2) mesh
# ---------------------------------------------------------------------------

LAYOUT_SHAPE = (8, 12)
LAYOUT_SPECS = [P(("data", "model"), None), P(("model", "data"), None),
                P(None, ("data", "model")), P(None, ("model", "data")),
                P("data", "model"), P("model", "data"), P("model"),
                P(("model", "data"), "model")]


def _reference_blocks(out_path):
    """Each spec's block per device of the reference's NamedSharding on
    a (2, 2) mesh of 4 host devices (run in a subprocess whose XLA_FLAGS
    force them)."""
    from jax.sharding import NamedSharding
    assert len(jax.devices()) == 4
    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("data", "model"))
    coord = {d: (i, j) for i in range(2) for j in range(2)
             for d in [devs[i, j]]}
    out = {}
    for spec in LAYOUT_SPECS:
        try:
            idx = NamedSharding(mesh, JP(*spec)).devices_indices_map(
                LAYOUT_SHAPE)
        except Exception:  # noqa: BLE001 -- the reference refuses the spec
            out[repr(spec)] = None
            continue
        out[repr(spec)] = {
            f"{coord[d][0]},{coord[d][1]}": [
                [s.start or 0, LAYOUT_SHAPE[k] if s.stop is None else s.stop]
                for k, s in enumerate(sl)] for d, sl in idx.items()}
    with open(out_path, "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def reference_blocks(tmp_path_factory):
    here = Path(__file__).resolve().parent
    out = tmp_path_factory.mktemp("layout") / "blocks.json"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
               "count=4", JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [str(here.parent / "src"), str(here)]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, test_torch_sharding as t; "
         "t._reference_blocks(sys.argv[1])", str(out)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("spec", LAYOUT_SPECS, ids=repr)
def test_to_placements_gives_each_rank_the_reference_block(reference_blocks,
                                                           spec):
    mesh = AbstractMesh((2, 2), ("data", "model"))
    want = reference_blocks[repr(spec)]
    if want is None:        # the reference refuses it: so does the port
        with pytest.raises(ValueError):
            to_placements(spec, mesh, len(LAYOUT_SHAPE))
        return
    placements = to_placements(spec, mesh, len(LAYOUT_SHAPE))
    for i in range(2):
        for j in range(2):
            size, off = _compute_local_shape_and_global_offset(
                LAYOUT_SHAPE, (2, 2), [i, j], placements)
            got = [[o, o + n] for o, n in zip(off, size)]
            assert got == want[f"{i},{j}"], (spec, placements, i, j)


def test_batch_and_model_entries_follow_the_guard():
    with use_mesh(MESH):
        assert ctx.batch_entry(8) == "data"
        assert ctx.batch_entry(6) is None
        assert ctx.model_entry(4, 2) == "model"
        assert ctx.model_entry(4, 3) is None
    assert ctx.batch_entry(8) is None


@pytest.mark.parametrize("entries", [(("pod", "data"), "model"),
                                     ("model", None, "pod"), ()], ids=repr)
def test_named_sharding_is_the_reference_spec_on_the_installed_mesh(entries):
    from repro.sharding import ctx as jctx
    assert ctx.named_sharding(*entries) is None
    assert jctx.named_sharding(*entries) is None
    with jctx.use_mesh(_jax_mesh((4, 2), ("data", "model"))):
        want = jctx.named_sharding(*entries).spec
    with use_mesh(MESH):
        mesh, placements = ctx.named_sharding(*entries)
    assert mesh is MESH
    assert placements == to_placements(P(*want), MESH)
