"""Granite-4.0-H-Small on the port (``configs/granite_4p0_h_small.py``), on
the CPU at SMOKE_CONFIG's Granite-shaped size (a period (ssm, attn), 8
experts of which 4 held, top-4, a shared expert, the three multipliers,
NoPE): its published shape, its loss and gradients and its serving
against the plain reference (``fedbench/reference/granite_hybrid.py``),
the expert share, its spans, and the twinned configs' operations as they
were before the port-only fields."""

import dataclasses
import hashlib
import math

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fedbench.reference import granite_hybrid as ref
from repro_torch import obs
from repro_torch.configs import granite_4p0_h_small as granite
from repro_torch.configs.base import (ARCH_IDS, PORT_ARCH_IDS, ArchConfig,
                                      PortArchConfig, get_arch)
from repro_torch.core.fedlite import flat_params, nest_like
from repro_torch.launch.specs import make_model
from repro_torch.lint import dispatch
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import apply_mlp

SMOKE = granite.SMOKE_CONFIG
B, S = 2, 64          # two SSD chunks of 32


@pytest.fixture(autouse=True)
def two_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def model_dict(cfg) -> dict:
    """The reference's ``model`` dict of a config."""
    return dataclasses.asdict(cfg)


def params_of(cfg, seed=0):
    """The port's params from a seeded init, its flat leaves (requiring
    grad) and the reference's copy (f32)."""
    model = make_model(cfg, with_pq=False)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    flat = {k: v.requires_grad_() for k, v in flat_params(params).items()}
    refp = {k: v.detach().clone().float().requires_grad_()
            for k, v in flat.items()}
    return model, nest_like(params, flat), flat, refp


def tokens(seed=1, s=S):
    return torch.randint(0, SMOKE.vocab_size, (B, s),
                         generator=torch.Generator().manual_seed(seed))


def test_published_shape():
    cfg = get_arch("granite_4p0_h_small")
    assert get_arch("granite-4p0-h-small") == cfg
    assert isinstance(cfg, PortArchConfig)
    assert "granite_4p0_h_small" in PORT_ARCH_IDS
    assert "granite_4p0_h_small" not in ARCH_IDS
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size, cfg.period) == \
        (40, 4096, 100352, 10)
    assert [i for i in range(40) if cfg.block_kind(i) == "attn"] == \
        [5, 15, 25, 35]
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 8, 128)
    assert (cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_inner, cfg.ssm_state,
            cfg.ssm_conv_width, cfg.ssm_chunk) == (128, 64, 8192, 128, 4,
                                                   256)
    assert (cfg.num_experts, cfg.experts_per_token, cfg.d_ff,
            cfg.shared_d_ff, cfg.experts_held) == (72, 10, 768, 1536, 0)
    assert (cfg.embedding_multiplier, cfg.residual_multiplier,
            cfg.logits_scaling, cfg.attention_multiplier) == \
        (12.0, 0.22, 16.0, 1 / 128)
    assert cfg.position_embedding == "nope" and cfg.tie_embeddings
    assert cfg.norm_eps == 1e-5 and cfg.padded_vocab == 100352
    # 32B-A9B
    assert 32.0e9 < cfg.param_count() < 32.5e9
    assert 8.5e9 < cfg.param_count(active_only=True) < 9.0e9
    held = dataclasses.replace(cfg, experts_held=18, num_layers=20)
    assert 6.0e9 < held.param_count() < 6.2e9


def test_port_fields_are_not_the_reference_fields():
    """ArchConfig keeps the reference's fields; the port-only ones are
    PortArchConfig's, after them, and a bad share is refused."""
    names = [f.name for f in dataclasses.fields(ArchConfig)]
    port = [f.name for f in dataclasses.fields(PortArchConfig)]
    assert port[:len(names)] == names
    assert set(port[len(names):]) == {
        "shared_d_ff", "experts_held", "first_expert_held",
        "embedding_multiplier", "residual_multiplier", "logits_scaling",
        "attention_multiplier", "position_embedding", "ssm_decay_f32"}
    with pytest.raises(ValueError, match="not among"):
        dataclasses.replace(SMOKE, first_expert_held=6)
    with pytest.raises(ValueError, match="position_embedding"):
        dataclasses.replace(SMOKE, position_embedding="alibi")


def test_loss_and_gradients_match_the_reference():
    cfg = SMOKE
    model, params, flat, refp = params_of(cfg)
    tok = tokens()
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    loss, _ = model.loss(params, batch, quantize=False)
    grads = torch.autograd.grad(loss, list(flat.values()))
    m = model_dict(cfg)
    r, mm = ref.lowprec.rounder("float32"), ref.lowprec.product("float32")
    x = torch.nn.functional.embedding(tok, refp["client/tok_embed"]) \
        * m["embedding_multiplier"]
    x, aux_c = ref.run_side(refp, "client", x, m, r, mm)
    x, aux_s = ref.run_side(refp, "server", x, m, r, mm)
    x = ref.rms_norm(x, refp["server/final_norm/scale"], m["norm_eps"])
    head = refp["client/tok_embed"][:m["vocab_size"]].t()
    want = ref.ce_sum(x, head, batch["labels"], m["logits_scaling"], mm) \
        / batch["labels"].numel() + aux_c + aux_s
    want.backward()      # the reference's reentrant checkpoints: no .grad()
    want_grads = [v.grad for v in refp.values()]
    assert abs(float(loss.detach()) - float(want.detach())) < \
        1e-5 * abs(float(want.detach()))
    for k, g, w in zip(flat, grads, want_grads):
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-9, k


def test_prefill_then_decode_match_the_reference_forward():
    """Logits of a prefill of P tokens and of G decode steps through the
    KV and SSM caches against the reference's full forward over the P + G
    tokens (within 1e-4 of the largest logit: f32 sums in other
    orders)."""
    cfg = SMOKE
    model, params, _, refp = params_of(cfg, seed=3)
    P, G = 40, 5
    tok = tokens(seed=4, s=P + G)
    with torch.no_grad():
        want = ref.logits_of(refp, tok, model_dict(cfg))
        caches = model.init_caches(B, P + G, "cpu")
        lg, caches = model.prefill(params, {"tokens": tok[:, :P]}, caches)
        got = [lg[:, -1]]
        for i in range(G - 1):
            lg, caches = model.decode_step(params, caches,
                                           tok[:, P + i:P + i + 1], P + i)
            got.append(lg[:, -1])
    got = torch.stack(got, 1)[..., :cfg.vocab_size]
    scale = float(want.abs().max())
    assert float((got - want[:, P - 1:P + G - 1]).abs().max()) < 1e-4 * scale


def test_expert_shares_sum_to_the_whole_layer():
    """Two chips' disjoint held sets that cover the 8 experts: their parts
    of the MoE layer, plus the shared expert counted once, add up to the
    uncut reference layer's; each share computes the whole layer's
    balance loss."""
    whole = dataclasses.replace(SMOKE, experts_held=0)
    g = torch.Generator().manual_seed(5)
    p = moe_mod.moe_init(g, whole, torch.float32, device="cpu")
    shared = {k: torch.randn(s, generator=g) * s[0] ** -0.5 for k, s in
              (("w_gate", (256, 256)), ("w_up", (256, 256)),
               ("w_down", (256, 256)))}
    x = torch.randn(B, S, whole.d_model, generator=g)
    parts, auxes = [], []
    for first in (0, 4):
        cfg = dataclasses.replace(SMOKE, experts_held=4,
                                  first_expert_held=first)
        share = {k: v[first:first + 4] if k.startswith("we_") else v
                 for k, v in p.items()}
        y, a = moe_mod.apply_moe(share, x, cfg)
        parts.append(y)
        auxes.append(a)
    got = parts[0] + parts[1] + apply_mlp(shared, x, "swiglu")
    m = model_dict(whole)
    mm = ref.lowprec.product("float32")
    want, aux = ref.moe(p, x, m, mm)
    want = want + ref.swiglu(x, shared["w_gate"], shared["w_up"],
                             shared["w_down"], mm)
    assert float((got - want).norm()) < 1e-5 * float(want.norm())
    assert torch.equal(auxes[0], auxes[1])
    assert abs(float(auxes[0]) - float(aux)) < 1e-6
    # a share alone is not the layer
    assert float((parts[0] - want).norm()) > 0.1 * float(want.norm())


SPANS = {"ssm.scan": 2, "moe.route": 4, "moe.dispatch": 4,
         "moe.experts": 4, "moe.combine": 4, "moe.shared": 4}


def test_spans_fire_once_a_layer_in_a_forward():
    """One forward of the smoke model (2 SSM and 2 attention layers, each
    with its MoE and shared expert) with a recorder on; the args are host
    values."""
    model, params, _, _ = params_of(SMOKE)
    obs.configure(run="granite")
    try:
        with torch.no_grad():
            model.loss(params, {"tokens": tokens(),
                                "labels": tokens()}, quantize=False)
    finally:
        rec = obs.shutdown()
    spans = [e for e in rec.events if e["type"] == "span"]
    counts = {n: sum(e["name"] == n for e in spans) for n in SPANS}
    assert counts == SPANS
    for e in spans:
        assert all(isinstance(v, (int, float, str))
                   for v in e["args"].values()), e
    scan = [e for e in spans if e["name"] == "ssm.scan"][0]
    assert scan["args"] == {"chunks": 2, "chunk": 32, "route": "plain"}
    route = [e for e in spans if e["name"] == "moe.route"][0]
    assert route["args"] == {"k": 4, "capacity": 80, "experts_held": 4}


def test_spans_add_no_host_sync():
    """A training step's ops that make the host wait: the same with a
    recorder on as with none."""
    model, params, flat, _ = params_of(SMOKE)
    batch = {"tokens": tokens(), "labels": tokens(seed=2)}

    def step():
        loss, _ = model.loss(params, batch, quantize=False)
        torch.autograd.grad(loss, list(flat.values()))
    off = dispatch.host_syncs(step)
    obs.configure(run="granite")
    try:
        on = dispatch.host_syncs(step)
    finally:
        obs.shutdown()
    assert [s.op for s in on] == [s.op for s in off]


def test_lint_accepts_the_spans():
    from repro_torch.lint.__main__ import main
    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    assert main([str(root / "src/repro_torch/models"),
                 str(root / "src/repro_torch/configs")]) == 0


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else [out]
        self.ops.append(f"{func} " + str([
            tuple(t.shape) + (str(t.dtype),) for t in outs
            if isinstance(t, torch.Tensor)]))
        return out


def op_trace(cfg):
    """(sha256 of the ops of a smoke training forward and backward with
    their output shapes and dtypes, their count, the loss as hex)."""
    model = make_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    leaves = flat_params(params)
    for v in leaves.values():
        v.requires_grad_()
    tok = torch.randint(0, 512, (2, 64),
                        generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, 1)}
    with _Ops() as ops:
        loss, _ = model.loss(params, batch)
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return (hashlib.sha256("\n".join(ops.ops).encode()).hexdigest()[:16],
            len(ops.ops), float(loss.detach()).hex())


# the op traces and losses of the twinned smoke models before the port-only
# fields (read at the parent of the change that added them, two threads)
BEFORE = {"mixtral_8x22b": ("8b93836b375c3170", 1597,
                            "0x1.bd52440000000p+2"),
          "jamba_v0p1_52b": ("e7fabd77547b185c", 3493,
                             "0x1.b627c80000000p+2"),
          "mamba2_1p3b": ("63c3c9aa3708e3f7", 2259,
                          "0x1.941ffc0000000p+2")}


@pytest.mark.parametrize("arch", sorted(BEFORE))
def test_twinned_models_run_the_operations_they_ran_before(arch):
    """The smoke Mixtral (and the SSM models, whose scan the f32 decay
    touches) run the same ops, shapes and dtypes as before, to the same
    loss; a PortArchConfig at its defaults runs them too."""
    cfg = get_arch(arch, smoke=True)
    trace, n, loss = op_trace(cfg)
    assert (trace, n) == BEFORE[arch][:2]
    assert math.isclose(float.fromhex(loss), float.fromhex(BEFORE[arch][2]),
                        rel_tol=1e-6)
    port = PortArchConfig(**dataclasses.asdict(cfg))
    assert op_trace(port) == (trace, n, loss)


def test_held_dispatch_ranks_as_the_one_hot_count():
    """The held share's sorted ranking gives the one-hot running count's
    slots, and its dropped pairs spread over the dump rows."""
    g = torch.Generator().manual_seed(6)
    gate_idx = torch.randint(0, 8, (2, 50, 3), generator=g)
    dest, keep = moe_mod.dispatch_slots(gate_idx, 8, 16)
    got, got_keep = moe_mod.dispatch_slots(gate_idx, 8, 16, held=4, first=2)
    local = gate_idx - 2
    mine = (local >= 0) & (local < 4)
    assert torch.equal(got_keep, keep & mine)
    assert torch.equal(got[got_keep], dest[got_keep] - 2 * 16)
    dumped = got[~got_keep]
    assert bool((dumped >= 4 * 16).all())
    assert bool((dumped < 4 * 16 + moe_mod.DUMP_ROWS).all())
    assert len(dumped.unique()) > 1


def test_cached_einsum_path_runs_torch_einsums_ops():
    """The SSD's einsum with its contraction path looked up once a set of
    shapes dispatches the ops ``torch.einsum`` does, to the same values."""
    from repro_torch.kernels.ref import cached_einsum
    g = torch.Generator().manual_seed(7)
    ops = (torch.randn(2, 8, 8, generator=g),
           torch.randn(2, 3, 8, 8, generator=g),
           torch.randn(2, 8, 3, 5, generator=g))
    traces = []
    for fn in (torch.einsum, cached_einsum):
        with _Ops() as rec:
            out = fn("bij,bhij,bjhp->bihp", *ops)
        traces.append((rec.ops, out))
    assert traces[0][0] == traces[1][0]
    assert torch.equal(traces[0][1], traces[1][1])
