"""The SSD scan's CUDA kernels (``kernels/ssd_scan.py``,
``csrc/ssd_scan.cu``): on the CPU the wrapper, the routing in
``ops.ssd_scan``, the span's route, the wrapper's checks and the
backward's algebra as the kernels compute it (in f64, against autograd
through the plain scan); on a card the kernels against the plain scan.

The card tests skip themselves without CUDA (decided inside each test).
This file imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu --noconftest \\
        tests/test_torch_ssd_kernel.py
"""

import pytest
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models import ssm

BF16, F32 = torch.bfloat16, torch.float32


def _inputs(B, S, H, N, *, seed=0, dev="cpu", with_h0=False, P=64):
    """x, B, C ~ N(0, 1); dt = softplus(N(−2, 0.5²)) (about 0.13); A from
    −0.5 to −8: decays of 0.06 to 1 a step, as a trained Mamba-2 has."""
    g = torch.Generator().manual_seed(seed)
    xh = torch.randn((B, S, H, P), generator=g)
    dt = F.softplus(torch.randn((B, S, H), generator=g) * 0.5 - 2.0)
    A = -torch.exp(torch.empty(H).uniform_(-0.7, 2.1, generator=g))
    bc = torch.randn((B, S, 2 * N), generator=g)
    h0 = torch.randn((B, H, P, N), generator=g) if with_h0 else None
    out = [xh, dt, A, bc[..., :N], bc[..., N:], h0]
    return [None if t is None else t.to(dev) for t in out]


def _stream(xh, dt, A, Bm, Cm, h0):
    """Granite's combination: x, B and C in bf16 (B and C the halves of
    one tensor, as ``apply_ssm`` slices them), dt and A in f32."""
    bc = torch.cat([Bm, Cm], -1).to(BF16)
    N = Bm.shape[-1]
    return xh.to(BF16), dt, A, bc[..., :N], bc[..., N:], h0


# ---------------------------------------------------------------------------
# CPU


@pytest.mark.parametrize("with_h0", [False, True])
def test_wrapper_on_cpu_is_the_plain_scan_bitwise(with_h0):
    """On a CPU tensor the wrapper (``ops.ssd_scan``) is the plain version
    (``ref.ssd_scan_ref``), y, the final state and the gradients bitwise;
    and ``models/ssm.ssd_scan`` itself takes the plain route there."""
    ins = _stream(*_inputs(2, 64, 3, 64, with_h0=with_h0))
    outs = []
    for fn in (ops.ssd_scan, ref.ssd_scan_ref, ssm.ssd_scan):
        leaves = [t.clone().requires_grad_() if t is not None else None
                  for t in ins]
        y, h = fn(*leaves[:5], 32, h0=leaves[5])
        (y.float().square().sum() + h.square().sum()).backward()
        outs.append([y, h] + [t.grad for t in leaves if t is not None])
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)


class _Like:
    """What the routing reads of a tensor (shape, dtype, strides, address,
    device), for a CUDA tensor on a machine without one."""

    def __init__(self, shape, dtype, cuda, strides=None):
        self.shape, self.dtype, self.is_cuda = torch.Size(shape), dtype, cuda
        self.device = torch.device("cuda:0" if cuda else "cpu")
        self._dense = torch.empty(shape, device="meta").stride()
        self._strides = strides or self._dense

    def dim(self):
        return len(self.shape)

    def stride(self, i=None):
        return self._strides if i is None else self._strides[i]

    def is_contiguous(self):
        return self._strides == self._dense

    def data_ptr(self):
        return 0


def _route_args(stream=BF16, decay=F32, S=512, chunk=256, N=128, P=64,
                cuda=True):
    """Inputs as ``apply_ssm`` makes them: B and C the halves of one
    (B, S, 2N) tensor."""
    B, H = 2, 4
    half = (S * 2 * N, 2 * N, 1)
    return (_Like((B, S, H, P), stream, cuda), _Like((B, S, H), decay, cuda),
            _Like((H,), decay, cuda), _Like((B, S, N), stream, cuda, half),
            _Like((B, S, N), stream, cuda, half), chunk)


@pytest.mark.parametrize("case,kw,want", [
    ("granite", {}, True),
    ("state 64, chunk 48", {"N": 64, "chunk": 48, "S": 192}, True),
    ("cpu", {"cuda": False}, False),
    ("bf16 decay (mamba2, jamba)", {"decay": BF16}, False),
    ("f32 stream", {"stream": F32}, False),
    ("undivided sequence", {"S": 500}, False),
    ("sequence under a chunk", {"S": 128}, False),
    ("chunk not a multiple of 16", {"chunk": 24, "S": 480}, False),
    ("chunk over 256", {"chunk": 512}, False),
    ("head dim 32", {"P": 32}, False),
    ("state 16", {"N": 16}, False),
])
def test_kernel_route_conditions(case, kw, want):
    """The kernel route only for a CUDA x with x, B, C in bf16 and dt, A in
    f32, P 64, N 64 or 128, a chunk that is a multiple of 16 up to 256
    and divides S; the rest stays plain."""
    route = ops.ssd_scan_route(*_route_args(**kw))
    assert route == ("kernel" if want else "plain"), case


def _scan_span():
    ins = _stream(*_inputs(1, 64, 2, 64))
    obs.configure(run="ssd")
    try:
        with torch.no_grad():
            ssm.ssd_scan(*ins[:5], 32)
    finally:
        rec = obs.shutdown()
    return [e for e in rec.events
            if e["type"] == "span" and e["name"] == "ssm.scan"]


def test_scan_span_carries_the_route(monkeypatch):
    """``ssm.scan`` says which route ran: "plain" on the CPU, "kernel"
    where the conditions hold (the kernels stubbed by the plain version)."""
    spans = _scan_span()
    assert [e["args"] for e in spans] == [
        {"chunks": 2, "chunk": 32, "route": "plain"}]
    calls = []

    def stub(*args, **kw):
        calls.append(args[5])
        return ref.ssd_scan_ref(*args, **kw)
    monkeypatch.setattr(ops, "ssd_scan_route", lambda *a: "kernel")
    monkeypatch.setattr(ops, "ssd_scan_kernel", stub)
    spans = _scan_span()
    assert [e["args"] for e in spans] == [
        {"chunks": 2, "chunk": 32, "route": "kernel"}]
    assert calls == [32]


def _bad_inputs(case, dev="cpu"):
    xh, dt, A, Bm, Cm, h0 = _stream(*_inputs(2, 64, 3, 64, with_h0=True,
                                             dev=dev))
    chunk = 32
    if case == "x f32":
        xh = xh.float()
    elif case == "x transposed":
        xh = xh.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "x misaligned":
        buf = torch.empty(xh.numel() + 1, dtype=BF16, device=xh.device)
        xh = buf[1:].view(xh.shape)
    elif case == "dt bf16":
        dt = dt.to(BF16)
    elif case == "A (1, H)":
        A = A[None]
    elif case == "B f32":
        Bm = Bm.float()
    elif case == "C strided":
        Cm = torch.cat([Cm, Cm], -1)[..., ::2]
    elif case == "B and C apart":
        Cm = Cm.contiguous()
    elif case == "state 16":
        Bm, Cm = Bm[..., :16], Cm[..., :16]
    elif case == "head dim 32":
        xh = xh[..., :32].contiguous()
    elif case == "chunk 24":
        chunk = 24
    elif case == "chunk 512":
        xh, dt, Bm, Cm = (torch.cat([t] * 8, 1) for t in (xh, dt, Bm, Cm))
        chunk = 512
    elif case == "h0 shape":
        h0 = h0[:1]
    return xh, dt, A, Bm, Cm, chunk, h0


BAD = ["x f32", "x transposed", "x misaligned", "dt bf16", "A (1, H)",
       "B f32", "C strided", "B and C apart", "state 16", "head dim 32",
       "chunk 24", "chunk 512", "h0 shape"]


@pytest.mark.parametrize("case", BAD)
def test_check_refuses_what_the_kernels_do_not_take(case):
    """The wrapper's check raises on dtypes, shapes and strides the kernels
    do not read (it reads only shapes, strides and addresses, so it runs
    here); the inputs as ``apply_ssm`` makes them pass."""
    good = _bad_inputs("none")
    kssd.check(*good[:6], h0=good[6])
    with pytest.raises(ValueError):
        args = _bad_inputs(case)
        kssd.check(*args[:6], h0=args[6])


def kernel_algebra(xh, dt, A, Bm, Cm, Cs, h0, dy, dh):
    """The scan and its gradients as the kernels decompose them, in plain
    PyTorch: the forward's entry states and outputs, the reverse pass (G,
    the gradient leaving each chunk, and ⟨G, h_c⟩), the head sums of
    L·dt·(dy·xᵀ) for dB and dC, the parts through the states, and ∂/∂cum
    as Q's row sums less its column sums, plus the parts through the entry
    state and the chunk's state (Q[i][j] = (dy_i·x_j)·(C·Bᵀ)[i][j]·L·dt_j)."""
    B, S, H, P = xh.shape
    N, nc = Bm.shape[-1], S // Cs

    def chunks(t):
        return t.reshape(B, nc, Cs, *t.shape[2:])
    x, d, Bc, Cc, g = (chunks(t) for t in (xh, dt, Bm, Cm, dy))
    cum = (d * A).cumsum(2)                                  # (B,nc,Cs,H)
    cE = cum[:, :, -1]                                       # (B,nc,H)
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    mask = torch.ones(Cs, Cs, dtype=torch.bool).tril()
    diff = cum.permute(0, 1, 3, 2)[..., :, None] \
        - cum.permute(0, 1, 3, 2)[..., None, :]             # (B,nc,H,i,j)
    L = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    e_end = torch.exp(cE[:, :, None] - cum)                  # (B,nc,Cs,H)
    h = torch.zeros(B, H, P, N, dtype=xh.dtype) if h0 is None else h0
    hin = []
    for c in range(nc):
        hin.append(h)
        h = torch.exp(cE[:, c])[..., None, None] * h + torch.einsum(
            "bjh,bjhp,bjn->bhpn", e_end[:, c] * d[:, c], x[:, c], Bc[:, c])
    hT = h

    def y_of(c):
        intra = torch.einsum("bij,bhij,bjh,bjhp->bihp", CB[:, c], L[:, c],
                             d[:, c], x[:, c])
        inter = torch.exp(cum[:, c])[..., None] * torch.einsum(
            "bin,bhpn->bihp", Cc[:, c], hin[c])
        return intra + inter
    y = torch.cat([y_of(c) for c in range(nc)], 1)
    dh_ = torch.zeros_like(hT) if dh is None else dh
    G, t4 = [None] * nc, [None] * nc
    for c in reversed(range(nc)):
        G[c] = dh_
        t4[c] = torch.exp(cE[:, c]) * (dh_ * hin[c]).sum((-1, -2))
        dh_ = torch.exp(cE[:, c])[..., None, None] * dh_ + torch.einsum(
            "bih,bihp,bin->bhpn", torch.exp(cum[:, c]), g[:, c], Cc[:, c])
    dx, ddt, dB, dC = [], [], [], []
    dA = torch.zeros_like(A)
    for c in range(nc):
        M = CB[:, c, None] * L[:, c]                         # (B,H,i,j)
        acc1 = torch.einsum("bhij,bihp->bjhp", M, g[:, c])
        acc2 = torch.einsum("bjn,bhpn->bjhp", Bc[:, c], G[c])
        e = e_end[:, c]
        v = acc1 + e[..., None] * acc2
        dx.append(d[:, c, ..., None] * v)
        z = (x[:, c] * v).sum(-1)
        u = d[:, c] * e * (x[:, c] * acc2).sum(-1)
        Q = torch.einsum("bihp,bjhp->bhij", g[:, c], x[:, c]) * M \
            * d[:, c].permute(0, 2, 1)[:, :, None, :]
        y_in = torch.exp(cum[:, c]) * (g[:, c] * torch.einsum(
            "bin,bhpn->bihp", Cc[:, c], hin[c])).sum(-1)
        dcum = (Q.sum(-1) - Q.sum(-2)).permute(0, 2, 1) + y_in - u
        dcum[:, -1] += u.sum(1) + t4[c]
        da = dcum.flip(1).cumsum(1).flip(1)
        ddt.append(z + A * da)
        dA = dA + (d[:, c] * da).sum((0, 1))
        dcb = torch.einsum("bhij,bjh,bihp,bjhp->bij", L[:, c], d[:, c],
                           g[:, c], x[:, c])
        dC.append(torch.einsum("bij,bjn->bin", dcb, Bc[:, c])
                  + torch.einsum("bih,bihp,bhpn->bin", torch.exp(cum[:, c]),
                                 g[:, c], hin[c]))
        dB.append(torch.einsum("bij,bin->bjn", dcb, Cc[:, c])
                  + torch.einsum("bjh,bjhp,bhpn->bjn", e * d[:, c], x[:, c],
                                 G[c]))
    return (y, hT, torch.cat(dx, 1), torch.cat(ddt, 1), dA,
            torch.cat(dB, 1), torch.cat(dC, 1), dh_)


@pytest.mark.parametrize("with_h0,with_dh", [(False, False), (True, True),
                                             (True, False)])
def test_kernel_algebra_is_the_scan_and_its_gradients(with_h0, with_dh):
    """In f64, the decomposition the backward kernels compute equals the
    plain scan and its autograd gradients (dx, ddt, dA, dB, dC, dh0),
    within 1e-9 of each gradient's norm."""
    xh, dt, A, Bm, Cm, h0 = (None if t is None else t.double() for t in
                             _inputs(2, 96, 3, 8, P=4, with_h0=True))
    g = torch.Generator().manual_seed(9)
    dy = torch.randn(xh.shape, generator=g, dtype=torch.float64)
    dh = torch.randn(h0.shape, generator=g, dtype=torch.float64) \
        if with_dh else None
    h0 = h0 if with_h0 else None
    leaves = [t.clone().requires_grad_() for t in (xh, dt, A, Bm, Cm)]
    if with_h0:
        leaves.append(h0.clone().requires_grad_())
    y, hT = ref.ssd_scan_ref(*leaves[:5], 32,
                             h0=leaves[5] if with_h0 else None)
    loss = (y * dy).sum() + ((hT * dh).sum() if with_dh else 0.0)
    want = torch.autograd.grad(loss, leaves)
    got = kernel_algebra(xh, dt, A, Bm, Cm, 32, h0, dy, dh)
    y, hT = y.detach(), hT.detach()
    assert float((got[0] - y).norm()) <= 1e-9 * float(y.norm())
    assert float((got[1] - hT).norm()) <= 1e-9 * float(hT.norm())
    for a, b in zip(got[2:], want):
        assert float((a - b).norm()) <= 1e-9 * float(b.norm())


# ---------------------------------------------------------------------------
# card


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _run(fn, ins, chunk, dy, dh):
    """fn's y, final state and gradients (x, dt, A, B, C, h0) for the
    cotangents dy and dh (None: the loss reads y alone, as a training
    step's does), each leaf's gradient in f32."""
    leaves = [None if t is None else t.detach().clone().requires_grad_()
              for t in ins]
    y, h = fn(*leaves[:5], chunk, h0=leaves[5])
    loss = (y.float() * dy).sum()
    if dh is not None:
        loss = loss + (h.float() * dh).sum()
    grads = torch.autograd.grad(loss, [t for t in leaves if t is not None])
    return [y.detach().float(), h.detach().float()] \
        + [t.float() for t in grads]


NAMES = ["y", "h", "dx", "ddt", "dA", "dB", "dC", "dh0"]

# (B, S, H, N, chunk, h0, a gradient of the final state): Granite's SSD
# (8 x 4096 tokens, 128 heads of 64, state 128, chunk 256) and two small
# ones, one with a state handed in and one with a chunk that is not a
# multiple of the kernels' 64-row tiles; Granite's and the h0 shape again
# with the loss on y alone, as in a training step (the backward's state
# pass then starts from no gradient)
CARD_SHAPES = [(8, 4096, 128, 128, 256, False, True),
               (2, 512, 4, 128, 128, True, True),
               (1, 192, 3, 64, 48, False, True),
               (8, 4096, 128, 128, 256, False, False),
               (2, 512, 4, 128, 128, True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=[
    "granite", "h0", "cs48", "granite-no-dh", "h0-no-dh"])
def test_ssd_kernel_against_the_plain_scan_on_card(shape):
    """y, the final state and every gradient of the kernels within the
    plain bf16-stream route's relative L2 gap to the plain scan in f32
    (both against that f32 run, from the same bf16-rounded inputs); the
    kernel route is the one ``ssd_scan`` takes."""
    dev = _cuda_or_skip()
    B, S, H, N, chunk, with_h0, with_dh = shape
    ins = [None if t is None else t.to(dev) for t in
           _stream(*_inputs(B, S, H, N, seed=3, with_h0=with_h0))]
    assert ops.ssd_scan_route(*ins[:5], chunk, ins[5]) == "kernel"
    g = torch.Generator(device=dev).manual_seed(4)
    dy = torch.randn((B, S, H, 64), generator=g, device=dev).to(BF16)
    dh = torch.randn((B, H, 64, N), generator=g, device=dev) \
        if with_dh else None
    f32 = [None if t is None else t.float() for t in ins]
    want = _run(ref.ssd_scan_ref, f32, chunk, dy.float(), dh)
    plain = _run(ref.ssd_scan_ref, ins, chunk, dy, dh)
    got = _run(kssd.ssd_scan_kernel, ins, chunk, dy, dh)
    torch.cuda.synchronize()
    gaps = {n: (_rel(k, w), _rel(p, w))
            for n, k, p, w in zip(NAMES, got, plain, want)}
    shown = {n: f"{k:.3e} / {p:.3e}" for n, (k, p) in gaps.items()}
    print(shape, "kernel / plain:", shown)
    for name, (kernel_gap, plain_gap) in gaps.items():
        assert kernel_gap <= plain_gap, (name, shown)


@pytest.mark.gpu
def test_ssd_kernel_counts_and_repeats_bitwise_on_card():
    """One ``ssd_scan`` launch a forward, one ``ssd_scan_bwd`` a backward;
    two runs on the same inputs give the same bits, gradients included
    (the head sums and dA's are fixed-order)."""
    dev = _cuda_or_skip()
    ins = [None if t is None else t.to(dev) for t in
           _stream(*_inputs(2, 512, 8, 128, seed=6, with_h0=True))]
    g = torch.Generator(device=dev).manual_seed(7)
    dy = torch.randn((2, 512, 8, 64), generator=g, device=dev).to(BF16)
    dh = torch.randn((2, 8, 64, 128), generator=g, device=dev)
    _build.reset_launch_counts()
    with torch.no_grad():
        kssd.ssd_scan_kernel(*ins[:5], 128, h0=ins[5])
    assert _build.launch_counts() == {"ssd_scan": 1}
    _build.reset_launch_counts()
    first = _run(kssd.ssd_scan_kernel, ins, 128, dy, dh)
    assert _build.launch_counts() == {"ssd_scan": 1, "ssd_scan_bwd": 1}
    second = _run(kssd.ssd_scan_kernel, ins, 128, dy, dh)
    torch.cuda.synchronize()
    for name, a, b in zip(NAMES, first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("case", BAD)
def test_ssd_kernel_refuses_on_card(case):
    """The wrapper raises on CUDA inputs the kernels do not take, before
    any launch."""
    dev = _cuda_or_skip()
    args = _bad_inputs(case, dev)
    _build.reset_launch_counts()
    with pytest.raises(ValueError):
        kssd.ssd_scan_kernel(*args[:6], h0=args[6])
    assert _build.launch_counts() == {}
