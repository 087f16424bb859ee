"""Adafactor's update: the plain version against the optimizer's arithmetic
as it was written inline, on the CPU, and the CUDA kernel against the plain
version, on a card.

On the CPU the optimizer hands each leaf to ``ref.adafactor_update_ref``;
its updates and its state must be bitwise those of the inline arithmetic
(``_inline_update`` below), step after step: the same operations in the
same order. The card tests skip themselves without CUDA (decided inside
each test). This file imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
        tests/test_torch_adafactor_kernel.py
"""

import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.adafactor import (adafactor_update_kernel,
                                           adafactor_update_sharded)
from repro_torch.models.layout import inverse, ref_axes
from repro_torch.optim import adafactor, warmup_cosine
from repro_torch.optim.optimizers import _adafactor_beta

EPS = 1e-30

# leaves as the models have them: name -> (shape, dtype); the conv weight
# is OIHW, factored over I and O in the reference's HWIO layout
LEAVES = {
    "w2": ((6, 5), torch.bfloat16),
    "w3": ((2, 3, 40), torch.bfloat16),
    "w4": ((1, 2, 48, 40), torch.bfloat16),
    "norm": ((1, 6144), torch.bfloat16),
    "bias": ((7,), torch.bfloat16),
    "router": ((1, 64, 8), torch.float32),
    "client.conv1_w": ((32, 1, 5, 5), torch.float32),
}


def _inline_update(grads, state, lr_t, eps, clip):
    """The optimizer's update as it was written inline, leaf by leaf:
    (updates, new state, each leaf's clip divisor d)."""
    step = state["step"] + 1
    beta, one_minus = _adafactor_beta(step)
    upd, new_v, divisors = {}, {}, {}
    for k, g in grads.items():
        axes = ref_axes(k)
        v = state["v"][k]
        g32 = g.float()
        if axes is not None:
            g32 = g32.permute(axes).contiguous()
        g2 = g32.square() + eps
        if "full" in v:
            vn = beta * v["full"] + one_minus * g2
            rms = vn.sqrt()
            new_v[k] = {"full": vn}
        else:
            row = beta * v["row"] + one_minus * g2.mean(-1)
            col = beta * v["col"] + one_minus * g2.mean(-2)
            mean = row.mean(-1, keepdim=True)[..., None]
            rms = (row[..., None] * col[..., None, :]
                   / mean.clamp_min(eps)).sqrt()
            new_v[k] = {"row": row, "col": col}
        u = g32 / rms.clamp_min(eps)
        urms = (u.square().mean() + eps).sqrt()
        d = (urms / clip).clamp_min(1.0)
        divisors[k] = float(d)
        u = u / d
        if axes is not None:
            u = u.permute(inverse(axes)).contiguous()
        upd[k] = (u * -lr_t).to(g.dtype)
    return upd, {"step": step, "v": new_v}, divisors


def _grads(r, leaves, dev="cpu", spread=True):
    """Gradients with every third row zero, of magnitudes spread over four
    decades (``spread``) or all of 1e-2."""
    out = {}
    for k, (shape, dt) in leaves.items():
        scale = 10.0 ** r.uniform(-4, 0) if spread else 1e-2
        g = r.standard_normal(shape) * scale
        if len(shape) >= 2 and shape[-2] > 2:
            g.reshape(-1, shape[-1])[::3] = 0.0
        out[k] = torch.from_numpy(g.astype(np.float32)).to(dt).to(dev)
    return out


def _params(leaves, dev="cpu"):
    return {k: torch.zeros(s, dtype=dt, device=dev)
            for k, (s, dt) in leaves.items()}


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("clip", [0.05, 1.0, 1e4])
@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_plain_version_is_the_inline_arithmetic_bitwise(leaf, clip):
    """Three steps of one leaf under a warm-up schedule: updates and state
    bitwise the inline arithmetic's; clip 0.05 engages on every step,
    1e4 on none (gradients of one magnitude, so u's RMS stays near 1)."""
    leaves = {leaf: LEAVES[leaf]}
    sched = warmup_cosine(0.01, 2, 5)
    opt = adafactor(sched, clip_threshold=clip)
    state = opt.init(_params(leaves))
    inline = state
    r = np.random.default_rng(7)
    for step in range(3):
        grads = _grads(r, leaves, spread=False)
        upd, state = opt.update(grads, state, None)
        want, inline, divisors = _inline_update(grads, inline, sched(step),
                                                EPS, clip)
        assert _same(upd[leaf], want[leaf])
        assert state["step"] == inline["step"]
        assert set(state["v"][leaf]) == set(inline["v"][leaf])
        for part, t in inline["v"][leaf].items():
            assert _same(state["v"][leaf][part], t)
        if clip == 0.05:
            assert divisors[leaf] > 1.0
        if clip == 1e4:
            assert divisors[leaf] == 1.0


def test_plain_version_all_leaves_at_once_bitwise():
    """Every leaf in one update (the conv weight's factors over I and O):
    bitwise the inline arithmetic, and the state in the reference's
    layout."""
    opt = adafactor(0.003)
    state = opt.init(_params(LEAVES))
    inline = state
    r = np.random.default_rng(11)
    for _ in range(2):
        grads = _grads(r, LEAVES)
        upd, state = opt.update(grads, state, None)
        want, inline, _ = _inline_update(grads, inline, 0.003, EPS, 1.0)
        for k in LEAVES:
            assert _same(upd[k], want[k])
            for part, t in inline["v"][k].items():
                assert _same(state["v"][k][part], t)
    assert state["v"]["client.conv1_w"]["row"].shape == (5, 5, 1)
    assert state["v"]["client.conv1_w"]["col"].shape == (5, 5, 32)


def test_kernel_wrapper_takes_the_plain_version_on_cpu():
    """On a CPU tensor ``ops`` computes the plain version (a
    non-contiguous view included) and launches nothing; the kernel's own
    entry raises there."""
    r = np.random.default_rng(3)
    g = torch.from_numpy(r.standard_normal((40, 24)).astype(np.float32))
    v = {"row": torch.rand(40), "col": torch.rand(24)}
    kw = dict(beta=0.5, one_minus=0.5, lr=0.01, eps=EPS, clip=1.0)
    _build.reset_launch_counts()
    want = ref.adafactor_update_ref(g, v, **kw)
    for got in (ops.adafactor_update(g, v, **kw),
                ops.adafactor_update(g.t().contiguous().t(), v, **kw)):
        assert _same(got[0], want[0])
        for part in v:
            assert _same(got[1][part], want[1][part])
    with pytest.raises(ValueError, match="CUDA"):
        adafactor_update_kernel(g, v, **kw)
    assert _build.launch_counts() == {}


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------

# the state: each factor is a sum of up to 32768 f32 terms, taken by the
# kernel in tiles of a warp's columns or 256 rows, then partials in order,
# and by torch in its own tree (and its mean multiplies by 1/N where the
# kernel divides): a few ulps apart, well under 1e-5 relative
STATE_RTOL = 1e-5
# the update: u moves with the factors by about 1e-6 relative, so a bf16
# value that lies that close to a rounding boundary may round the other
# way (one bf16 ulp); such values are a small share
BF16_EXACT_SHARE = 0.995
F32_UPDATE_RTOL = 1e-5

# a Mixtral expert stack, its embedding, a ragged C (values read one at a
# time), the router, a final norm's scale
CARD_SHAPES = [((1, 8, 6144, 16384), torch.bfloat16),
               ((32768, 6144), torch.bfloat16),
               ((3, 1001, 77), torch.bfloat16),
               ((3, 1001, 77), torch.float32),
               ((1, 6144, 8), torch.float32),
               ((6144,), torch.bfloat16)]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_inputs(shape, dtype, dev, seed=5):
    """A gradient of about 1e-3 with rows of zeros (an embedding's unused
    tokens), some of them with a zero state as well, and values of 1e-25
    here and there."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * 1e-3
    x.view(-1)[::1009] = 1e-25
    if len(shape) >= 2:
        x.view(-1, shape[-1])[::7] = 0.0
        v = {"row": torch.rand(shape[:-1], generator=g, device=dev) * 1e-6,
             "col": torch.rand(shape[:-2] + shape[-1:], generator=g,
                               device=dev) * 1e-6}
        v["row"].view(-1)[::5] = 0.0
    else:
        v = {"full": torch.rand(shape, generator=g, device=dev) * 1e-6}
    return x.to(dtype), v


def _ulps_apart(a, b):
    """|a − b| in units of the last place of bf16 values of like sign."""
    ia = a.view(torch.int16).int()
    ib = b.view(torch.int16).int()
    return (ia - ib).abs()


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [1.0, 1e4])
@pytest.mark.parametrize("shape,dtype", CARD_SHAPES)
def test_adafactor_kernel_matches_plain_on_card(shape, dtype, clip):
    """The new state within STATE_RTOL of the plain version's; bf16 updates
    exact on BF16_EXACT_SHARE of the elements and within one ulp on all,
    f32 updates within F32_UPDATE_RTOL; bitwise run to run."""
    dev = _cuda_or_skip()
    g, v = _card_inputs(shape, dtype, dev)
    kw = dict(beta=0.75, one_minus=0.25, lr=1e-3, eps=EPS, clip=clip)
    got, new = adafactor_update_kernel(g, v, **kw)
    again, new2 = adafactor_update_kernel(g, v, **kw)
    want, want_v = ref.adafactor_update_ref(g, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    for part in v:
        assert torch.equal(new[part], new2[part])
        rel = ((new[part] - want_v[part]).abs()
               / want_v[part].abs().clamp_min(1e-38)).max()
        assert float(rel) <= STATE_RTOL, (part, float(rel))
    assert got.dtype == dtype and got.shape == g.shape
    if dtype == torch.bfloat16:
        ulps = _ulps_apart(got, want)
        assert int(ulps.max()) <= 1
        assert float((ulps == 0).float().mean()) >= BF16_EXACT_SHARE
    else:
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max()
        assert float(rel) <= F32_UPDATE_RTOL
    assert bool((got[g == 0] == 0).all())


@pytest.mark.gpu
def test_adafactor_counts_its_launches_on_card():
    """One launch a leaf: the optimizer's update over three CUDA leaves
    counts three, and its updates are those of the kernel called alone."""
    dev = _cuda_or_skip()
    leaves = {"a": ((64, 96), torch.bfloat16), "b": ((96,), torch.bfloat16),
              "c": ((2, 40, 16), torch.float32)}
    opt = adafactor(0.01)
    state = opt.init(_params(leaves, dev))
    grads = _grads(np.random.default_rng(2), leaves, dev)
    _build.reset_launch_counts()
    upd, new = opt.update(grads, state, None)
    torch.cuda.synchronize()
    assert _build.launch_counts() == {"adafactor_update": 3}
    beta, one_minus = _adafactor_beta(1)
    for k in leaves:
        alone, v = adafactor_update_kernel(
            grads[k], state["v"][k], beta=beta, one_minus=one_minus,
            lr=0.01, eps=EPS, clip=1.0)
        assert torch.equal(upd[k], alone)
        for part in v:
            assert torch.equal(new["v"][k][part], v[part])


@pytest.mark.gpu
def test_adafactor_kernel_refuses_views_it_cannot_read_on_card():
    """A non-contiguous or misaligned gradient is refused by the kernel's
    wrapper; ``ops`` copies either first and gets the contiguous result."""
    dev = _cuda_or_skip()
    g, v = _card_inputs((64, 96), torch.bfloat16, dev)
    kw = dict(beta=0.0, one_minus=1.0, lr=1e-2, eps=EPS, clip=1.0)
    want, want_v = adafactor_update_kernel(g, v, **kw)
    buf = torch.empty(g.numel() + 1, device=dev, dtype=g.dtype)
    misaligned = buf[1:].view(g.shape)
    misaligned.copy_(g)
    assert misaligned.data_ptr() % 16 != 0
    transposed = g.t().contiguous().t()
    for bad in (misaligned, transposed):
        with pytest.raises(ValueError):
            adafactor_update_kernel(bad, v, **kw)
        got, got_v = ops.adafactor_update(bad, v, **kw)
        assert torch.equal(got, want)
        for part in v:
            assert torch.equal(got_v[part], want_v[part])
    with pytest.raises(ValueError):
        adafactor_update_kernel(g.half(), v, **kw)


# ---------------------------------------------------------------------------
# a DTensor's local blocks: the stages' sums added over a (2, 2) mesh
# ---------------------------------------------------------------------------

# gradients as a mesh lays them out: (shape, dtype, placements, whether
# the state takes the optimizer's layout or is replicated)
SHARDED = [((64, 40), torch.bfloat16, (Shard(1), Replicate()), True),
           ((1, 24, 48), torch.bfloat16, (Shard(1), Shard(2)), True),
           ((1, 4, 48, 24), torch.float32, (Shard(3), Shard(1)), True),
           ((3, 5, 7), torch.bfloat16, (Shard(2), Shard(0)), True),
           ((2, 6, 1), torch.float32, (Shard(2), Shard(1)), True),
           ((1, 48), torch.bfloat16, (Replicate(), Shard(1)), True),
           ((24, 48), torch.bfloat16, (Shard(0), Shard(1)), False),
           ((40,), torch.bfloat16, (Shard(0), Replicate()), True),
           ((40,), torch.float32, (Replicate(), Replicate()), True)]
WORLD = 4


def _torch_launch(lib, name, argtypes, *a):
    """The launchers of ``csrc/adafactor.cu`` in plain torch on CPU
    tensors (in ``_build.launch``'s place), so that the stages and the sums
    added over the mesh between them run without a card."""
    assert lib == "adafactor" and len(argtypes) == len(a), name
    def unit(g, row, col, total, nmat, rows, cols, mean_div, eps):
        m = (total / mean_div).clamp_min(eps).view(nmat, 1, 1)
        rms = (row.reshape(nmat, rows, 1) * col.reshape(nmat, 1, cols)
               / m).sqrt()
        return g.float().reshape(nmat, rows, cols) / rms.clamp_min(eps)

    def divisor(sumsq, count, eps, clip):
        return ((sumsq / count + eps).sqrt() / clip).clamp_min(1.0)

    if name == "adafactor_sums_launch":
        g, row_sum, col_sum, _, _, nmat, rows, cols, _, _, eps = a
        g2 = g.float().reshape(nmat, rows, cols).square() + eps
        row_sum.copy_(g2.sum(-1).reshape(-1))
        col_sum.copy_(g2.sum(-2).reshape(-1))
    elif name == "adafactor_factors_launch":
        (rs, cs, ro, co, rn, cn, total, nmat, rows, _, row_div, col_div,
         beta, one_minus) = a
        rn.view(-1).copy_(beta * ro.reshape(-1) + one_minus * (rs / row_div))
        cn.view(-1).copy_(beta * co.reshape(-1) + one_minus * (cs / col_div))
        total.copy_(rn.reshape(nmat, rows).sum(-1))
    elif name == "adafactor_squares_launch":
        g, row, col, total, sumsq, _, _, nmat, rows, cols, _, _, md, eps = a
        u = unit(g, row, col, total, nmat, rows, cols, md, eps)
        sumsq.copy_(u.square().sum().reshape(1))
    elif name == "adafactor_apply_launch":
        (g, row, col, total, sumsq, out, nmat, rows, cols, _, _, md, count,
         eps, clip, neg_lr) = a
        u = unit(g, row, col, total, nmat, rows, cols, md, eps)
        out.view(-1).copy_((u / divisor(sumsq, count, eps, clip)
                            * neg_lr).reshape(-1))
    elif name == "adafactor_full_squares_launch":
        g, v_old, v_new, sumsq, _, _, _, _, beta, one_minus, eps = a
        v_new.copy_(beta * v_old + one_minus * (g.float().square() + eps))
        u = g.float() / v_new.sqrt().clamp_min(eps)
        sumsq.copy_(u.square().sum().reshape(1))
    else:
        assert name == "adafactor_full_apply_launch", name
        g, v_new, sumsq, out, _, _, count, eps, clip, neg_lr = a
        u = g.float() / v_new.sqrt().clamp_min(eps)
        out.copy_(u / divisor(sumsq, count, eps, clip) * neg_lr)


def _block(full, mesh, placements):
    """The DTensor of ``full`` (the same on every rank) laid out by
    ``placements``: each rank's block sliced from it, no collective."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    size, off = compute_local_shape_and_global_offset(full.shape, mesh,
                                                      placements)
    index = tuple(slice(o, o + n) for o, n in zip(off, size))
    return DTensor.from_local(full[index].contiguous(), mesh, placements,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def _held_to(got, want, dtype):
    """The checks of the card test: the update exact on BF16_EXACT_SHARE of
    the elements and within one ulp (bf16) or within F32_UPDATE_RTOL."""
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if got.numel() == 0:
        return
    if dtype == torch.bfloat16:
        ulps = _ulps_apart(got, want)
        assert int(ulps.max()) <= 1
        assert float((ulps == 0).float().mean()) >= BF16_EXACT_SHARE
    else:
        rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max()
        assert float(rel) <= F32_UPDATE_RTOL


def _sharded_rank(rank, store, device, world):
    """One rank of a (2, 2) gloo mesh (world 4) or a (1, 1) mesh (world 1,
    the device's own backend): each SHARDED leaf's update through
    ``adafactor_update_sharded`` against the whole leaf's on this rank
    (the kernel on the card; on the CPU the plain version, the stages run
    by ``_torch_launch``), block by block; at world 1 also bitwise."""
    import torch.distributed as dist

    from repro_torch.kernels import adafactor as kernel
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    dev = torch.device(device)
    if device == "cpu":
        _build.launch = _torch_launch
        whole = ref.adafactor_update_ref if world > 1 else (
            lambda g, v, **kw: kernel._run(g, v, tuple(g.shape),
                                           kernel._no_sum, **kw))
    else:
        torch.cuda.set_device(0)
        whole = adafactor_update_kernel
    if world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
    try:
        mesh = make_debug_mesh(*((2, 2) if world > 1 else (1, 1)),
                               device=device)
        kw = dict(beta=0.75, one_minus=0.25, lr=1e-3, eps=EPS, clip=1.0)
        for i, (shape, dtype, places, laid) in enumerate(SHARDED):
            if not laid and device == "cuda" and world > 1:
                continue    # DTensor's all-gather over gloo on the card
            g_full, v_full = _card_inputs(shape, dtype, dev, seed=i)
            g = _block(g_full, mesh, places)
            state = adafactor(0.1).init({"w": g})["v"]["w"]
            v = {k: _block(v_full[k], mesh, t.placements if laid
                           else (Replicate(),) * 2)
                 for k, t in state.items()}
            _build.reset_launch_counts()
            got, new = adafactor_update_sharded(g, v, **kw)
            assert _build.launch_counts() == {"adafactor_update": 1}
            want, want_v = whole(g_full, v_full, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            assert tuple(got.placements) == places, (shape, places)
            _held_to(got.to_local(), _block(want, mesh, places).to_local(),
                     dtype)
            if world == 1:
                assert torch.equal(got.to_local(), want)
            for k, t in new.items():
                assert tuple(t.placements) == tuple(v[k].placements)
                part = t.to_local()
                wpart = _block(want_v[k], mesh, t.placements).to_local()
                rel = ((part - wpart).abs()
                       / wpart.abs().clamp_min(1e-38)).max() \
                    if part.numel() else torch.zeros(())
                assert float(rel) <= STATE_RTOL, (shape, k, float(rel))
                if world == 1:
                    assert torch.equal(part, want_v[k])
    finally:
        dist.destroy_process_group()


def _spawn_mesh(tmp_path, device, world):
    import torch.multiprocessing as mp
    mp.spawn(_sharded_rank, args=(str(tmp_path / "store"), device, world),
             nprocs=world)


@pytest.mark.parametrize("world", [1, 4])
def test_sharded_stages_add_their_sums_over_the_mesh(tmp_path, world):
    """The kernel's stages on a gloo mesh of the CPU, run by their
    plain-torch twins. On a (2, 2) mesh every block of the update and of
    the new state within the card tests' limits of the plain version on
    the whole leaf, for gradients split over either or both of a matrix's
    dims, over its leading dim, unevenly, into an empty block, and rank-1
    leaves; the state returned in its own layout (the optimizer's, or
    replicated). On a (1, 1) mesh bitwise the same stages on the whole
    leaf."""
    _spawn_mesh(tmp_path, "cpu", world)


@pytest.mark.gpu
@pytest.mark.parametrize("world", [1, 4])
def test_adafactor_sharded_kernel_on_card(tmp_path, world):
    """The kernel on the local blocks of a (1, 1) NCCL mesh, bitwise the
    kernel on the whole leaf, and of a (2, 2) mesh of four processes on
    the one card (gloo), within the card test's limits of it; the state
    in its own layout."""
    _cuda_or_skip()
    _spawn_mesh(tmp_path, "cuda", world)
