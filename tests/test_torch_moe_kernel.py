"""The MoE's dispatch and combine kernels (``kernels/moe_dispatch.py``,
``csrc/moe_dispatch.cu``): on the CPU the routing in ``ops.moe_dispatch``
/ ``ops.moe_combine``, the spans' route, the wrappers' checks and the
kernels' arithmetic written out in plain PyTorch against the plain route;
on a card the kernels against the plain route.

The card tests skip themselves without CUDA (decided inside each test).
This file imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
        tests/test_torch_moe_kernel.py
"""

import dataclasses
import math

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import mixtral_8x22b
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import moe_dispatch as kmoe
from repro_torch.models import moe

BF16, F32 = torch.bfloat16, torch.float32

# relative L2 gap of x's and the gates' gradients to the plain route's:
# the plain route rounds each of a token's k terms to the dtype (and each
# product of the gate's sum), the kernels sum in f32 and round once
TOL = {BF16: 2 ** -6, F32: 1e-5}
# f32 rounding of a sum in another order: how much farther from an f64
# computation the kernels' f32 gradients may lie than the plain route's
F32_SLACK = 1e-6


@dataclasses.dataclass(frozen=True)
class Shape:
    """A dispatch: G groups of Ng tokens, k of E experts each, H of them
    held from ``first`` (H = E: all), capacity factor cf, width D; ``skew``
    adds to the first expert's logit, so that it overflows its capacity."""
    G: int
    Ng: int
    E: int
    H: int
    k: int
    D: int
    cf: float = 1.25
    skew: float = 0.0
    first: int = 0

    @property
    def capacity(self) -> int:
        c = int(math.ceil(self.k * self.Ng / self.E * self.cf))
        return max(8, -(-c // 8) * 8)

    @property
    def dump(self) -> int:
        return 1 if self.H == self.E else moe.DUMP_ROWS


def case(s: Shape, dtype, *, seed=0, dev="cpu"):
    """x (G, Ng, D), the experts' output (G, H, C, D), the gates (f32,
    normalized over the top k), dest and keep from ``moe.dispatch_slots``,
    and cotangents for y and the expert buffer, all on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn((s.G, s.Ng, s.E), generator=g)
    logits[..., 0] += s.skew
    gate_w, gate_idx = moe.top_k(torch.softmax(logits, -1), s.k)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    dest, keep = moe.dispatch_slots(gate_idx, s.E, s.capacity,
                                    0 if s.H == s.E else s.H, s.first)
    x = torch.randn((s.G, s.Ng, s.D), generator=g)
    out = torch.randn((s.G, s.H, s.capacity, s.D), generator=g)
    dy = torch.randn((s.G, s.Ng, s.D), generator=g)
    de = torch.randn((s.G, s.H, s.capacity, s.D), generator=g)
    t = dict(x=x.to(dtype), out=out.to(dtype), gate_w=gate_w, dest=dest,
             keep=keep, dy=dy.to(dtype), de=de.to(dtype))
    return {n: v.to(dev) for n, v in t.items()}


# Granite's held share (72 experts, top 10, 18 held: three pairs in four
# go to the dump rows), Mixtral's full set with an overflowing expert,
# G > 1, k = 1, and a share that starts past expert 0
SHAPES = {
    "granite-share": Shape(1, 512, 72, 18, 10, 64, first=18),
    "mixtral-full": Shape(1, 256, 8, 8, 2, 48, skew=2.0),
    "groups": Shape(3, 128, 8, 8, 2, 32, cf=1.0, skew=1.0),
    "k1": Shape(2, 96, 4, 4, 1, 16, skew=1.5),
    "share-groups": Shape(2, 128, 16, 4, 4, 24, first=8),
}


def plain(t, s: Shape):
    """The plain route's ebuf, y and gradients (x, the experts' output,
    the gates) for the cotangents ``de`` and ``dy``."""
    x = t["x"].clone().requires_grad_()
    out = t["out"].clone().requires_grad_()
    gw = t["gate_w"].clone().requires_grad_()
    ebuf = ref.moe_dispatch_ref(x, t["dest"], s.H, s.capacity, s.dump)
    y = ref.moe_combine_ref(out, t["dest"], gw, t["keep"], s.dump)
    dx, = torch.autograd.grad(ebuf, x, t["de"])
    dout, dgate = torch.autograd.grad(y, (out, gw), t["dy"])
    return dict(ebuf=ebuf.detach(), y=y.detach(), dx=dx, dout=dout,
                dgate=dgate)


# ---------------------------------------------------------------------------
# the kernels' arithmetic in plain PyTorch


def slot_map(dest, keep, slots):
    """src (G, slots): the kept pair q = t·k + j at its slot, −1 where
    none is (``moe_slot_map``)."""
    G = dest.shape[0]
    src = torch.full((G, slots), -1, dtype=torch.long, device=dest.device)
    gi, qi = torch.nonzero(keep.reshape(G, -1), as_tuple=True)
    src[gi, dest.reshape(G, -1)[gi, qi]] = qi
    return src


def emulate_dispatch(xg, dest, keep, slots):
    """``moe_slot_gather`` with w = 1: each slot's row copied."""
    src = slot_map(dest, keep, slots)
    g = torch.arange(xg.shape[0], device=xg.device)[:, None]
    rows = xg[g, src.clamp_min(0) // dest.shape[-1]]
    return torch.where(src[..., None] >= 0, rows, torch.zeros_like(rows))


def emulate_combine(obuf, dest, keep, gate_w):
    """``moe_token_reduce``'s chain: p = T(f32(row)·T(w)), y = T(y + p)
    in choice order, a dropped pair adding +0."""
    T, (G, Ng, k), slots = obuf.dtype, dest.shape, obuf.shape[1]
    g = torch.arange(G, device=obuf.device)[:, None]
    w = gate_w.to(T).float()
    acc = torch.zeros((G, Ng, obuf.shape[-1]), device=obuf.device)
    for j in range(k):
        row = obuf[g, dest[:, :, j].clamp(max=slots - 1)].float()
        p = (row * w[:, :, j, None]).to(T).float()
        acc = torch.where(keep[:, :, j, None], (acc + p).to(T).float(),
                          acc + 0.0)
    return acc.to(T)


def emulate_combine_bwd(dy, obuf, dest, keep, gate_w):
    """``moe_slot_gather`` with the gates: d(out)[s] = T(f32(dy[t])·T(w)),
    and each kept pair's Σ_d out[s]·dy[t] in f32."""
    T, (G, Ng, k), slots = obuf.dtype, dest.shape, obuf.shape[1]
    src = slot_map(dest, keep, slots)
    g = torch.arange(G, device=obuf.device)[:, None]
    q = src.clamp_min(0)
    gy = dy[g, q // k].float()
    w = gate_w.to(T).float().reshape(G, -1)[g, q]
    full = src[..., None] >= 0
    dobuf = torch.where(full, (gy * w[..., None]).to(T),
                        torch.zeros((), dtype=T, device=obuf.device))
    dots = (obuf.float() * gy).sum(-1)
    dgate = torch.zeros((G, Ng * k), device=obuf.device)
    gi, si = torch.nonzero(src >= 0, as_tuple=True)
    dgate[gi, src[gi, si]] = dots[gi, si]
    return dobuf, dgate.reshape(G, Ng, k)


def emulate_dispatch_bwd(dout, dest, keep):
    """``moe_token_reduce`` with w = 1: the kept rows summed in f32,
    rounded once."""
    G, Ng, k = dest.shape
    slots = dout.shape[1]
    g = torch.arange(G, device=dout.device)[:, None]
    acc = torch.zeros((G, Ng, dout.shape[-1]), device=dout.device)
    for j in range(k):
        row = dout[g, dest[:, :, j].clamp(max=slots - 1)].float()
        acc = acc + torch.where(keep[:, :, j, None], row, 0.0)
    return acc.to(dout.dtype)


def emulated(t, s: Shape):
    slots = s.H * s.capacity
    obuf = t["out"].reshape(s.G, slots, s.D)
    dobuf, dgate = emulate_combine_bwd(t["dy"], obuf, t["dest"], t["keep"],
                                       t["gate_w"])
    ebuf = emulate_dispatch(t["x"], t["dest"], t["keep"], slots)
    return dict(
        ebuf=ebuf.reshape(s.G, s.H, s.capacity, s.D),
        y=emulate_combine(obuf, t["dest"], t["keep"], t["gate_w"]),
        dx=emulate_dispatch_bwd(t["de"].reshape(s.G, slots, s.D), t["dest"],
                                t["keep"]),
        dout=dobuf.reshape(s.G, s.H, s.capacity, s.D), dgate=dgate)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


# ---------------------------------------------------------------------------
# CPU


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_arithmetic_is_the_plain_route(name, dtype):
    """The kernels' arithmetic, written out: the expert buffer, y and the
    experts' output gradient bitwise the plain route's (the combine's
    rounding chain is the plain route's), x's and the gates' gradients
    within ``TOL`` of it; the shape drops pairs, and the kernels' sums
    are nearer an f64 computation than the plain route's (or within f32
    rounding of it)."""
    s = SHAPES[name]
    t = case(s, dtype, seed=1)
    assert not bool(t["keep"].all())
    want, got = plain(t, s), emulated(t, s)
    for n in ("ebuf", "y", "dout"):
        assert torch.equal(got[n], want[n]), n
    exact = plain({n: v.double() if v.is_floating_point() else v
                   for n, v in t.items()}, s)
    for n in ("dx", "dgate"):
        assert rel(got[n], want[n]) <= TOL[dtype], n
        slack = F32_SLACK if dtype == F32 else 0.0
        assert rel(got[n], exact[n]) <= rel(want[n], exact[n]) + slack, n


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_wrappers_on_cpu_are_the_plain_route_bitwise(dtype):
    """On CPU tensors ``ops.moe_dispatch`` / ``ops.moe_combine`` are the
    plain versions, outputs and gradients bitwise."""
    s = SHAPES["granite-share"]
    t = case(s, dtype, seed=2)
    want = plain(t, s)
    x = t["x"].clone().requires_grad_()
    out = t["out"].clone().requires_grad_()
    gw = t["gate_w"].clone().requires_grad_()
    ebuf = ops.moe_dispatch(x, t["dest"], t["keep"], s.H, s.capacity, s.dump)
    y = ops.moe_combine(out, t["dest"], gw, t["keep"], s.dump)
    dx, = torch.autograd.grad(ebuf, x, t["de"])
    dout, dgate = torch.autograd.grad(y, (out, gw), t["dy"])
    got = dict(ebuf=ebuf, y=y, dx=dx, dout=dout, dgate=dgate)
    for n, v in want.items():
        assert torch.equal(got[n], v), n


class _Like:
    """What the routing reads of a tensor (shape, dtype, device), for a
    CUDA tensor on a machine without one."""

    def __init__(self, shape, dtype, cuda=True):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda:0" if cuda else "cpu")

    def dim(self):
        return len(self.shape)

    def element_size(self):
        return torch.empty((), dtype=self.dtype).element_size()


def _route_args(D=4096, dtype=BF16, G=1, Ng=32768, k=10, cuda=True,
                rows=None):
    rows = rows or (G, Ng, D)
    return (_Like(rows, dtype, cuda), _Like((G, Ng, k), torch.int64, cuda),
            _Like((G, Ng, k), torch.bool, cuda))


@pytest.mark.parametrize("case_,kw,want", [
    ("granite x", {}, "kernel"),
    ("granite's expert output", {"rows": (1, 18, 5696, 4096)}, "kernel"),
    ("mixtral", {"D": 6144, "Ng": 16384, "k": 2}, "kernel"),
    ("f32, D 4", {"dtype": F32, "D": 4}, "kernel"),
    ("groups", {"G": 4, "Ng": 8192}, "kernel"),
    ("cpu", {"cuda": False}, "plain"),
    ("bf16, D 12", {"D": 12}, ValueError),
    ("f32, D 6", {"dtype": F32, "D": 6}, ValueError),
    ("f16", {"dtype": torch.float16}, ValueError),
    ("k over 1024", {"k": 1025, "Ng": 64}, ValueError),
    ("groups over 65535", {"G": 65536, "Ng": 1}, ValueError),
])
def test_kernel_route_conditions(case_, kw, want):
    """Every CUDA tensor takes the kernel route and the CPU the plain one:
    the kernels take bf16 or f32 rows of whole 16-byte vectors, k up to
    1024 and up to 65535 groups, and ``ops.moe_dispatch`` raises on the
    rest of the card's inputs rather than run the plain version there."""
    rows, dest, keep = _route_args(**kw)
    assert ops.moe_route(rows) == ("plain" if want == "plain" else
                                   "kernel"), case_
    if want == "kernel":
        kmoe.check(rows, dest, keep)
    elif want is ValueError:
        with pytest.raises(ValueError, match="moe_dispatch: "):
            ops.moe_dispatch(rows, dest, keep, 18, 8, moe.DUMP_ROWS)


def _bad(name):
    t = case(SHAPES["groups"], BF16)
    rows, dest, keep = t["x"], t["dest"], t["keep"]
    if name == "D 12":
        rows = rows[..., :12]
    elif name == "f16":
        rows = rows.half()
    elif name == "dest int32":
        dest = dest.int()
    elif name == "keep uint8":
        keep = keep.to(torch.uint8)
    elif name == "keep shape":
        keep = keep[:, :-1]
    elif name == "groups differ":
        rows = rows[:1]
    return rows, dest, keep


@pytest.mark.parametrize("name", ["D 12", "f16", "dest int32", "keep uint8",
                                  "keep shape", "groups differ"])
def test_check_refuses_what_the_kernels_do_not_take(name):
    """The wrappers' check raises on dtypes and shapes the kernels do not
    read (it reads only shapes and dtypes, so it runs here); the inputs as
    ``apply_moe`` makes them pass."""
    kmoe.check(*_bad("none"))
    with pytest.raises(ValueError):
        kmoe.check(*_bad(name))


@pytest.mark.parametrize("entry", ["dispatch", "combine"])
def test_kernel_entries_raise_on_a_cpu_tensor(entry):
    """``moe_dispatch_kernel`` and ``moe_combine_kernel`` launch the kernels
    or raise: a CPU tensor is refused, never routed to the plain version."""
    s = SHAPES["k1"]
    t = case(s, BF16)
    with pytest.raises(ValueError, match="CUDA"):
        if entry == "dispatch":
            kmoe.moe_dispatch_kernel(t["x"], t["dest"], t["keep"],
                                     s.H * s.capacity)
        else:
            kmoe.moe_combine_kernel(
                t["out"].reshape(s.G, s.H * s.capacity, s.D), t["dest"],
                t["keep"], t["gate_w"])


SMOKE = dataclasses.replace(mixtral_8x22b.SMOKE_CONFIG, capacity_factor=0.5)


def _moe_spans(x, p):
    obs.configure(run="moe")
    try:
        with torch.no_grad():
            y, _ = moe.apply_moe(p, x, SMOKE)
    finally:
        rec = obs.shutdown()
    spans = [e for e in rec.events if e["type"] == "span"
             and e["name"] in ("moe.dispatch", "moe.combine")]
    return y, spans


def test_spans_carry_the_route(monkeypatch):
    """``moe.dispatch`` and ``moe.combine`` say which route ran: "plain"
    on the CPU, "kernel" where the conditions hold (the kernels stubbed
    by their arithmetic written out, which gives the plain route's y)."""
    gen = torch.Generator().manual_seed(4)
    p = moe.moe_init(gen, SMOKE, F32, device="cpu")
    x = torch.randn((2, 32, SMOKE.d_model), generator=gen)
    args = {"k": SMOKE.experts_per_token,
            "capacity": moe.capacity_of(SMOKE, 64),
            "experts_held": SMOKE.num_experts}
    want, spans = _moe_spans(x, p)
    assert [(e["name"], e["args"]) for e in spans] == [
        ("moe.dispatch", {**args, "route": "plain"}),
        ("moe.combine", {**args, "route": "plain"})]
    calls = []

    def dispatch(xg, dest, keep, slots):
        calls.append("dispatch")
        return emulate_dispatch(xg, dest, keep, slots)

    def combine(obuf, dest, keep, gate_w):
        calls.append("combine")
        return emulate_combine(obuf, dest, keep, gate_w)
    monkeypatch.setattr(ops, "moe_route", lambda *a: "kernel")
    monkeypatch.setattr(ops, "moe_dispatch_kernel", dispatch)
    monkeypatch.setattr(ops, "moe_combine_kernel", combine)
    got, spans = _moe_spans(x, p)
    assert [(e["name"], e["args"]) for e in spans] == [
        ("moe.dispatch", {**args, "route": "kernel"}),
        ("moe.combine", {**args, "route": "kernel"})]
    assert calls == ["dispatch", "combine"]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# card


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def kernel_route(t, s: Shape):
    """The kernels' ebuf, y and gradients, as ``plain`` gives the plain
    route's."""
    slots = s.H * s.capacity
    x = t["x"].clone().requires_grad_()
    out = t["out"].clone().requires_grad_()
    gw = t["gate_w"].clone().requires_grad_()
    ebuf = kmoe.moe_dispatch_kernel(x, t["dest"], t["keep"], slots)
    y = kmoe.moe_combine_kernel(out.reshape(s.G, slots, s.D), t["dest"],
                                t["keep"], gw)
    dx, = torch.autograd.grad(ebuf, x, t["de"].reshape(s.G, slots, s.D))
    dout, dgate = torch.autograd.grad(y, (out, gw), t["dy"])
    return dict(ebuf=ebuf.detach().reshape(s.G, s.H, s.capacity, s.D),
                y=y.detach(), dx=dx, dout=dout, dgate=dgate)


# the CPU shapes, and Granite's and Mixtral's cells at full size: Granite
# 32768 tokens a group, 18 of 72 experts held, top 10, D 4096; Mixtral
# 16384 tokens, 8 experts, top 2, D 6144
CARD_SHAPES = {**SHAPES,
               "granite-cell": Shape(1, 32768, 72, 18, 10, 4096),
               "mixtral-cell": Shape(1, 16384, 8, 8, 2, 6144, skew=0.5)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(CARD_SHAPES))
def test_moe_kernels_against_the_plain_route_on_card(name, dtype):
    """The expert buffer, y and the experts' output gradient of the kernels
    ``torch.equal`` the plain route's on the card, the empty slots zero;
    x's and the gates' gradients within ``TOL`` of the plain route's and
    no farther from an f64 computation than it is (f32: within f32
    rounding of it)."""
    dev = _cuda_or_skip()
    s = CARD_SHAPES[name]
    t = case(s, dtype, seed=3, dev=dev)
    assert ops.moe_route(t["x"]) == "kernel"
    assert not bool(t["keep"].all())
    got, want = kernel_route(t, s), plain(t, s)
    torch.cuda.synchronize()
    for n in ("ebuf", "y", "dout"):
        assert torch.equal(got[n], want[n]), n
    full = slot_map(t["dest"], t["keep"], s.H * s.capacity) >= 0
    assert not bool(full.all())
    for n in ("ebuf", "dout"):
        rows = got[n].reshape(s.G, -1, s.D)
        assert not bool(rows[~full].any()), n
    exact = plain({n: v.double() if v.is_floating_point() else v
                   for n, v in t.items()}, s)
    slack = F32_SLACK if dtype == F32 else 0.0
    shown = {n: f"{rel(got[n], exact[n]):.3e} / {rel(want[n], exact[n]):.3e}"
             for n in ("dx", "dgate")}
    print(name, dtype, "kernel / plain to f64:", shown)
    for n in ("dx", "dgate"):
        assert rel(got[n], want[n]) <= TOL[dtype], (n, shown)
        assert rel(got[n], exact[n]) <= rel(want[n], exact[n]) + slack, \
            (n, shown)


@pytest.mark.gpu
def test_moe_kernels_count_and_repeat_bitwise_on_card():
    """One ``moe_dispatch`` and one ``moe_combine`` launch a forward, one
    ``moe_dispatch_bwd`` and one ``moe_combine_bwd`` a backward; two runs
    on the same inputs give the same bits, gradients included."""
    dev = _cuda_or_skip()
    s = SHAPES["granite-share"]
    t = case(s, BF16, seed=6, dev=dev)
    _build.reset_launch_counts()
    runs = [kernel_route(t, s) for _ in range(2)]
    assert _build.launch_counts() == {
        "moe_dispatch": 2, "moe_combine": 2, "moe_dispatch_bwd": 2,
        "moe_combine_bwd": 2}
    for n, v in runs[0].items():
        assert torch.equal(v, runs[1][n]), n


@pytest.mark.gpu
def test_moe_layer_takes_the_kernels_on_card(monkeypatch):
    """A bf16 MoE layer (the Mixtral smoke config, capacity factor 0.5) on
    the card: both spans say "kernel", and its output equals the layer's
    on the plain route, bitwise."""
    dev = _cuda_or_skip()
    gen = torch.Generator().manual_seed(8)
    p = moe.moe_init(gen, SMOKE, BF16, device="cpu")
    p = {k: v.to(dev) for k, v in p.items()}
    x = torch.randn((2, 64, SMOKE.d_model), generator=gen).to(BF16).to(dev)
    got, spans = _moe_spans(x, p)
    assert [e["args"]["route"] for e in spans] == ["kernel", "kernel"]
    monkeypatch.setattr(ops, "moe_route", lambda *a: "plain")
    want, spans = _moe_spans(x, p)
    assert [e["args"]["route"] for e in spans] == ["plain", "plain"]
    assert torch.equal(got, want)
