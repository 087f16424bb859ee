"""The port's production-mesh dry run (``repro_torch/launch/dryrun.py``)
and its analysis (``launch/analysis.py``) against the JAX package's.

  * the twin of tests/test_dryrun.py: starcoder2_3b x decode_32k traced on
    the single-pod and multi-pod meshes over a fake process group (one
    subprocess, ``--mesh both``): worlds of 256 and 512, the card's HBM
    key true, a roofline bound, FLOPs, collectives;
  * the long_500k skip note of an arch with full attention only;
  * ``roofline_terms`` and the ring formulas of ``collective_stats``
    equal to the reference's functions on the same inputs (the reference
    reads its collectives from HLO lines written for them);
  * the twin of tests/test_system.py's spec-builder sweep: input, cache and
    train-state specs of every (arch x input shape) on a 1 x 1 mesh, every
    local block a FakeTensor (no device memory);
  * ``DeviceCost`` counts a row-parallel product's reduce-scatter and its
    local FLOPs on a fake 4-rank mesh.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

from repro.launch import analysis as janalysis
from repro_torch.configs.base import (ARCH_IDS, InputShape, get_arch,
                                      supports_shape)
from repro_torch.core.fedlite import flat_params
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import (HBM_BW, HBM_KEY, NVLINK_BW_PER_LINK,
                                     NVLINK_LINKS, PEAK_FLOPS_BF16)
from repro_torch.launch.specs import (cache_specs, input_specs, make_model,
                                      state_specs)
from repro_torch.optim import get_optimizer

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def decode_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "starcoder2_3b", "--shape", "decode_32k", "--mesh", "both",
         "--out", str(out), "--force"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    recs = {}
    for mesh in ("single", "multi"):
        with open(out / f"starcoder2_3b__decode_32k__{mesh}.json") as f:
            recs[mesh] = json.load(f)
    return recs


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_one_combo(decode_records, mesh):
    rec = decode_records[mesh]
    assert "error" not in rec
    assert rec["world"] == (512 if mesh == "multi" else 256)
    assert rec["mesh"] == ("2x16x16" if mesh == "multi" else "16x16")
    assert rec[HBM_KEY]
    assert rec["roofline"]["bound"] in ("compute", "memory", "collective")
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]  # the sharded program communicates
    assert 0 < rec["memory"]["argument_size_in_bytes"] \
        <= rec["device_bytes"]


def test_dryrun_skip_note(tmp_path):
    rec = dryrun.run_one("llama3_8b", "long_500k", "single", str(tmp_path))
    assert "skipped" in rec   # full attention @ 500k: skip-with-note
    with open(tmp_path / "llama3_8b__long_500k__single.json") as f:
        assert "skipped" in json.load(f)


@pytest.mark.parametrize("args", [
    (3.2e12, 5.1e10, 7.0e8), (1e9, 4e12, 0.0), (5e14, 1e9, 9e11)])
def test_roofline_terms_match_the_reference(args):
    kw = dict(peak_flops=PEAK_FLOPS_BF16, hbm_bw=HBM_BW,
              ici_bw=NVLINK_BW_PER_LINK, num_links=NVLINK_LINKS)
    assert analysis.roofline_terms(*args, **kw) == \
        janalysis.roofline_terms(*args, **kw)
    # the default link count is the H100's
    assert analysis.roofline_terms(*args, **{
        k: v for k, v in kw.items() if k != "num_links"}) == \
        janalysis.roofline_terms(*args, **kw)


# (HLO kind, HLO result type, group) and the same collective as the port
# records it (kind, result payload bytes, group size)
COLLECTIVES = [
    ("all-gather", "bf16[16,512]{1,0}", "{{0,1,2,3}}", 16 * 512 * 2, 4),
    ("all-gather", "f32[64]{0}", "{{0,1}}", 64 * 4, 2),
    ("reduce-scatter", "f32[8,128]{1,0}", "{{0,1,2,3,4,5,6,7}}",
     8 * 128 * 4, 8),
    ("all-reduce", "f32[1024]{0}", "{{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,"
     "15}}", 1024 * 4, 16),
    ("all-reduce", "bf16[2,4]{1,0}", "{{0,1}}", 2 * 4 * 2, 2),
    ("all-to-all", "bf16[32,64]{1,0}", "{{0,1,2,3}}", 32 * 64 * 2, 4),
]


def test_collective_stats_match_the_reference_ring_formulas():
    hlo = "\n".join(
        f"  %{kind}.{i} = {typ} {kind}(%x.{i}), replica_groups={groups}"
        for i, (kind, typ, groups, _, _) in enumerate(COLLECTIVES))
    want = janalysis.collective_stats(hlo, world=16)
    got = analysis.collective_stats(
        (kind, nbytes, g) for kind, _, _, nbytes, g in COLLECTIVES)
    assert got == want
    assert analysis.total_wire_bytes(got) == janalysis.total_wire_bytes(want)


@pytest.fixture
def world_of_one():
    """A process group of one (a fake one, torn down after) unless one is
    initialised already."""
    owns = not dist.is_initialized()
    if owns:
        dryrun.fake_world(1)
    try:
        yield
    finally:
        if owns:
            dist.destroy_process_group()


SMALL = {
    "train_4k": InputShape("train_4k", 128, 8, "train"),
    "prefill_32k": InputShape("prefill_32k", 128, 4, "prefill"),
    "decode_32k": InputShape("decode_32k", 128, 4, "decode"),
    "long_500k": InputShape("long_500k", 256, 1, "decode"),
}


def test_spec_builders_cover_all_arch_shape_pairs(world_of_one):
    """input_specs / cache_specs / state_specs build for every supported
    (arch x shape) on a 1 x 1 mesh, every local block a FakeTensor."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cpu", torch.zeros((1, 1), dtype=torch.int),
                      mesh_dim_names=("data", "model"))

    def fake(tree):
        leaves = list(flat_params(tree).values()) if isinstance(tree, dict) \
            else [tree]
        assert leaves
        return all(isinstance(t.to_local(), FakeTensor) for t in leaves)

    for arch in ARCH_IDS:
        cfg = get_arch(arch, smoke=True)
        model = make_model(cfg)
        for sname, shp in SMALL.items():
            if not supports_shape(arch, sname):
                continue
            b = input_specs(cfg, shp, mesh, with_labels=shp.kind == "train")
            assert "tokens" in b and fake(b)
            cs = cache_specs(model, shp.global_batch, shp.seq_len, mesh)
            assert isinstance(cs, dict) and fake(cs)
        ss = state_specs(model, get_optimizer("adam", 1e-3), mesh)
        assert ss.params["client"] and fake(ss.params)
        assert fake(ss.opt_state["m"])


def _row_parallel_cost():
    """y = x @ w with the contraction split over a fake world of 4 (run
    in a subprocess: the process's default group is this one's)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    dryrun.fake_world(4)
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("model",))
    cost = analysis.DeviceCost()
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(8, 16), mesh, (Shard(1),),
                               run_check=False)
        w = DTensor.from_local(torch.empty(16, 32), mesh, (Shard(0),),
                               run_check=False)
        cost.hold((x, w))
        with cost:
            (x @ w).redistribute(mesh, (Shard(0),))
    print(json.dumps({"flops": cost.flops, "collectives": cost.collectives,
                      "arguments": cost.arguments, "peak": cost.peak}))


def test_device_cost_counts_a_row_parallel_product():
    """Each of 4 ranks multiplies its (8, 16) block by its (16, 32) block
    (2·8·16·32 FLOPs), and the partial sums meet in one reduce-scatter of
    the (8, 32) f32 result, each rank keeping its (2, 32) rows (the
    payload)."""
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(here)]))
    proc = subprocess.run(
        [sys.executable, "-c", "import test_torch_dryrun as t; "
         "t._row_parallel_cost()"], env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["flops"] == 2 * 8 * 16 * 32
    assert got["collectives"] == [["reduce-scatter", 2 * 32 * 4, 4]]
    assert got["arguments"] == (8 * 16 + 16 * 32) * 4
    assert got["peak"] >= got["arguments"] + 8 * 32 * 4
