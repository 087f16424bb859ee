"""Parity of the port's transformer stack with the JAX package: configs,
norms, MLPs, RoPE / M-RoPE, the attention paths and blocks, and the split
Llama-3 8B smoke model's prefill (with and without the PQ uplink) and
decode steps, on the CPU.

Inputs come from a numpy seed; the model weights are the reference's,
converted by ``from_jax_params``, so both packages start from the same
numbers. The JAX side runs its "jnp" quantizer backend and its row-block
attention; the port runs plain PyTorch on the CPU (its prefill attention
is the flash kernel's plain version there). Float results agree at f32
noise; each test states its tolerance.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import llama3_8b as jllama
from repro.core.quantizer import quantize as jquantize
from repro.launch.specs import make_model as jmake_model
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import rope as jrope
from repro_torch.configs import base as tbase
from repro_torch.configs import llama3_8b as tllama
from repro_torch.core.quantizer import quantize as tquantize
from repro_torch.launch.specs import make_model as tmake_model
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rope as trope
from repro_torch.models.transformer import TransformerLM, from_jax_params

REPO_ROOT = Path(__file__).resolve().parents[1]
# f32 results of two frameworks: matmuls and reductions sum in other orders
RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _configs(**fields):
    """The same ArchConfig in both packages."""
    return jbase.ArchConfig(**fields), tbase.ArchConfig(**fields)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CONFIG", "SMOKE_CONFIG"])
def test_llama3_config_matches_reference(name):
    """Every field value for value, every derived property, the parameter
    count, and the compute dtype as a torch dtype."""
    j, t = getattr(jllama, name), getattr(tllama, name)
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    for f in dataclasses.fields(j):
        assert getattr(j, f.name) == getattr(t, f.name), f.name
    for prop in ("period", "num_periods", "padded_vocab", "q_dim", "kv_dim",
                 "d_inner", "ssm_heads"):
        assert getattr(j, prop) == getattr(t, prop), prop
    assert j.param_count() == t.param_count()
    assert j.param_count(active_only=True) == t.param_count(active_only=True)
    assert t.compute_dtype == getattr(torch, j.dtype)
    assert tbase.get_arch("llama3_8b", smoke=name == "SMOKE_CONFIG") is t
    assert tbase.get_arch("llama3-8b") is tllama.CONFIG


def test_input_shapes_and_arch_ids_match_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tbase.INPUT_SHAPES.keys() == jbase.INPUT_SHAPES.keys()
    for k, v in jbase.INPUT_SHAPES.items():
        assert dataclasses.asdict(tbase.INPUT_SHAPES[k]) == \
            dataclasses.asdict(v)


@pytest.mark.parametrize("arch", [a for a in jbase.ARCH_IDS
                                  if a != "llama3_8b"])
def test_unported_archs_raise_naming_the_roadmap(arch):
    """Once these ids raised, naming ROADMAP A15; every id now resolves to
    the reference's config, and only an unknown id raises."""
    assert tbase.get_arch(arch) == tbase.get_arch(arch.replace("_", "-"))
    assert tbase.get_arch(arch).name == jbase.get_arch(arch).name
    with pytest.raises(ValueError, match="unknown"):
        tbase.get_arch("no_such_arch")


@pytest.mark.parametrize("field,value", [("num_experts", 4),
                                         ("layer_pattern", ("ssm",)),
                                         ("num_codebooks", 4),
                                         ("vision_embed_dim", 32)])
def test_unported_families_raise(field, value):
    """Once these families raised, naming ROADMAP A15; a Llama smoke model
    turned into each family now builds, with the family's leaves in the
    reference's shapes."""
    extra = {"num_experts": {"experts_per_token": 2},
             "layer_pattern": {"ssm_state": 16}}.get(field, {})
    fields = {field: value, **extra}
    tcfg = dataclasses.replace(tllama.SMOKE_CONFIG, **fields)
    jcfg = dataclasses.replace(jllama.SMOKE_CONFIG, **fields)
    params = TransformerLM(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.eval_shape(jmake_model(jcfg).init, jax.random.PRNGKey(0))
    assert jax.tree.map(lambda t: tuple(t.shape), params) == \
        jax.tree.map(lambda a: tuple(a.shape), jshapes)


# ---------------------------------------------------------------------------
# layers and rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(norm_type):
    r = np.random.default_rng(1)
    x = (r.standard_normal((2, 5, 32)) * 3 + 1).astype(np.float32)
    p = {"scale": r.standard_normal(32).astype(np.float32)}
    if norm_type == "layernorm":
        p["bias"] = r.standard_normal(32).astype(np.float32)
    want = jlayers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                              norm_type, 1e-5)
    got = tlayers.apply_norm({k: _t(v) for k, v in p.items()}, _t(x),
                             norm_type, 1e-5)
    _close(got, want)
    # bf16 in, bf16 out (computed in f32)
    got16 = tlayers.apply_norm({k: _t(v) for k, v in p.items()},
                               _t(x).bfloat16(), norm_type, 1e-5)
    assert got16.dtype == torch.bfloat16


@pytest.mark.parametrize("mlp_type,use_bias", [("swiglu", False),
                                               ("geglu", False),
                                               ("gelu", True)])
def test_apply_mlp_matches_jax(mlp_type, use_bias):
    r = np.random.default_rng(2)
    jp = jlayers.mlp_init(jax.random.PRNGKey(0), 32, 64, mlp_type, use_bias,
                          jnp.float32)
    if use_bias:  # nonzero biases, so that they are held to the reference
        jp = {**jp, "w_up_b": jnp.asarray(r.standard_normal(64), jnp.float32),
              "w_down_b": jnp.asarray(r.standard_normal(32), jnp.float32)}
    x = r.standard_normal((2, 7, 32)).astype(np.float32)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), mlp_type)
    got = tlayers.apply_mlp(from_jax_params(_tree_np(jp)), _t(x), mlp_type)
    _close(got, want)
    tp = tlayers.mlp_init(torch.Generator().manual_seed(0), 32, 64, mlp_type,
                          use_bias, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: v.shape for k, v in jp.items()}


@pytest.mark.parametrize("mrope", [None, (8, 4, 4)])
def test_rope_matches_jax(mrope):
    r = np.random.default_rng(3)
    B, S, H, hd = 2, 9, 3, 32
    if mrope is None:
        pos = r.integers(0, 2000, (B, S)).astype(np.int32)
    else:
        pos = r.integers(0, 2000, (3, B, S)).astype(np.int32)
    ang_j = jrope.rope_angles(jnp.asarray(pos), hd, 500_000.0, mrope)
    ang_t = trope.rope_angles(_t(pos), hd, 500_000.0, mrope)
    assert ang_t.dtype == torch.float32 and ang_t.shape == (B, S, hd // 2)
    # angles up to 2000 rad: f32 powers and products round at ~1e-4 there
    _close(ang_t, ang_j, rtol=1e-6, atol=2e-4)
    x = r.standard_normal((B, S, H, hd)).astype(np.float32)
    # rotate by the same angles, so the rotation itself is compared
    _close(trope.apply_rope(_t(x), _t(np.asarray(ang_j))),
           jrope.apply_rope(jnp.asarray(x), ang_j))
    got16 = trope.apply_rope(_t(x).bfloat16(), ang_t)
    assert got16.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# attention paths
# ---------------------------------------------------------------------------

def _qkv(seed, B, S, H, Kv, hd):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(shape).astype(np.float32)
                 for shape in ((B, S, H, hd), (B, S, Kv, hd),
                               (B, S, Kv, hd)))


@pytest.mark.parametrize("window,q_chunk", [(None, 8), (None, 5), (6, 8)])
def test_row_block_attention_matches_jax(window, q_chunk):
    q, k, v = _qkv(4, 2, 24, 4, 2, 16)
    pos = np.arange(24, dtype=np.int32)
    want = jattn.row_block_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                     window=window, q_chunk=q_chunk,
                                     scale=0.25)
    got = tattn.row_block_attention(*map(_t, (q, k, v, pos, pos)),
                                    window=window, q_chunk=q_chunk,
                                    scale=0.25)
    _close(got, want)


def test_local_window_attention_matches_jax():
    q, k, v = _qkv(5, 2, 24, 4, 2, 16)
    pos = np.arange(24, dtype=np.int32)
    want = jattn.local_window_attention(*map(jnp.asarray, (q, k, v, pos, pos)),
                                        window=8, scale=0.25)
    got = tattn.local_window_attention(*map(_t, (q, k, v, pos, pos)),
                                       window=8, scale=0.25)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_jax(window):
    q, k, v = _qkv(6, 2, 12, 4, 2, 16)
    cpos = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, -1, -1, -1], np.int32)
    want = jattn.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(cpos), 8,
                                  window=window, scale=0.25)
    got = tattn.decode_attention(_t(q[:, :1]), _t(k), _t(v), _t(cpos), 8,
                                 window=window, scale=0.25)
    _close(got, want)


def _attn_case(window):
    """Attention params and an input of one block, in both packages."""
    jcfg, tcfg = _configs(name="t", family="dense", num_layers=2, d_model=64,
                          vocab_size=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, sliding_window=window, use_bias=True,
                          attn_q_chunk=8)
    jp = jattn.attn_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
    r = np.random.default_rng(7)
    jp = {**jp, "wq_b": jnp.asarray(r.standard_normal(64), jnp.float32)}
    x = r.standard_normal((2, 20, 64)).astype(np.float32)
    return jcfg, tcfg, jp, from_jax_params(_tree_np(jp)), x


@pytest.mark.parametrize("window,max_len", [(None, 24), (8, 24)])
def test_apply_attention_prefill_and_decode_match_jax(window, max_len):
    """Prefill over positions 0..S−1 (the port's flash route, its plain
    version here) fills the cache -- a ring of the last 8 tokens with a
    window -- and two decode steps follow; outputs and caches agree."""
    jcfg, tcfg, jp, tp, x = _attn_case(window)
    B, S = x.shape[:2]
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jc = jattn.init_attn_cache(jcfg, B, max_len, jnp.float32)
    tc = tattn.init_attn_cache(tcfg, B, max_len, torch.float32, device="cpu")
    y_j, jc = jattn.apply_attention(jp, jnp.asarray(x), jcfg,
                                    jnp.asarray(pos), mode="prefill",
                                    cache=jc)
    y_t, tc = tattn.apply_attention(tp, _t(x), tcfg, None, mode="prefill",
                                    cache=tc)
    _close(y_t, y_j)
    for key in ("k", "v", "pos"):
        _close(tc[key], jc[key])
    r = np.random.default_rng(8)
    for i in range(2):
        xd = r.standard_normal((B, 1, 64)).astype(np.float32)
        dpos = np.full((B, 1), S + i, np.int32)
        y_j, jc = jattn.apply_attention(jp, jnp.asarray(xd), jcfg,
                                        jnp.asarray(dpos), mode="decode",
                                        cache=jc, decode_pos=S + i)
        y_t, tc = tattn.apply_attention(tp, _t(xd), tcfg, None,
                                        mode="decode", cache=tc,
                                        decode_pos=S + i)
        _close(y_t, y_j)
        for key in ("k", "v", "pos"):
            _close(tc[key], jc[key])


def test_apply_attention_with_own_positions_matches_jax(monkeypatch):
    """A batch with its own positions takes the row-block path (never the
    flash route) in train and prefill mode."""
    jcfg, tcfg, jp, tp, x = _attn_case(None)
    B, S = x.shape[:2]
    pos = np.broadcast_to(np.arange(3, 3 + S, dtype=np.int32), (B, S)).copy()

    def no_flash(*a, **k):
        raise AssertionError("the flash route took explicit positions")
    monkeypatch.setattr(tattn, "flash_prefill_attention", no_flash)
    for mode in ("train", "prefill"):
        jc = jattn.init_attn_cache(jcfg, B, S, jnp.float32)
        tc = tattn.init_attn_cache(tcfg, B, S, torch.float32, device="cpu")
        y_j, _ = jattn.apply_attention(jp, jnp.asarray(x), jcfg,
                                       jnp.asarray(pos), mode=mode,
                                       cache=jc)
        y_t, _ = tattn.apply_attention(tp, _t(x), tcfg, _t(pos), mode=mode,
                                       cache=tc)
        _close(y_t, y_j)


def test_local_window_branch_is_plain_in_prefill(monkeypatch):
    """S > 2·window and S % window == 0: the local-window path, as in the
    reference, even over default positions."""
    jcfg, tcfg, jp, tp, x = _attn_case(5)
    B, S = x.shape[:2]
    monkeypatch.setattr(tattn, "flash_prefill_attention",
                        lambda *a, **k: pytest.fail("flash route taken"))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    y_j, jc = jattn.apply_attention(
        jp, jnp.asarray(x), jcfg, jnp.asarray(pos), mode="prefill",
        cache=jattn.init_attn_cache(jcfg, B, S, jnp.float32))
    y_t, tc = tattn.apply_attention(
        tp, _t(x), tcfg, None, mode="prefill",
        cache=tattn.init_attn_cache(tcfg, B, S, torch.float32, device="cpu"))
    _close(y_t, y_j)
    for key in ("k", "v", "pos"):
        _close(tc[key], jc[key])


# ---------------------------------------------------------------------------
# the split Llama-3 8B smoke model
# ---------------------------------------------------------------------------

B, S, GEN = 2, 16, 4


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = jllama.SMOKE_CONFIG, tllama.SMOKE_CONFIG
    jmodel, tmodel = jmake_model(jcfg), tmake_model(tcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = from_jax_params(_tree_np(jparams))
    tokens = np.random.default_rng(11).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
    return jmodel, tmodel, jparams, tparams, tokens


def _close_caches(tc, jc, rtol=RTOL, atol=ATOL):
    for part in ("client", "server"):
        for key in ("k", "v", "pos"):
            _close(tc[part]["p0"][key], jc[part]["p0"][key], rtol, atol)


def test_smoke_params_are_the_reference_layout(smoke):
    """``init`` draws the reference's shapes and dtypes, period-stacked;
    ``from_jax_params`` converts leaf for leaf."""
    jmodel, tmodel, jparams, tparams, _ = smoke
    own = tmodel.init(torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)

    def shapes(tree):
        return jax.tree.map(lambda t: (tuple(t.shape),
                                       str(t.dtype).split(".")[-1]), tree)
    assert shapes(own) == jshapes
    assert shapes(tparams) == jshapes
    np.testing.assert_array_equal(tparams["server"]["head"].numpy(),
                                  np.asarray(jparams["server"]["head"]))


def test_from_jax_params_keeps_bf16():
    """bf16 leaves (numpy's ml_dtypes bfloat16) convert bit for bit."""
    a = jnp.asarray(np.random.default_rng(9).standard_normal((3, 5)),
                    jnp.bfloat16)
    got = from_jax_params({"w": {"x": np.asarray(a)}})["w"]["x"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(a, np.float32))


@pytest.mark.parametrize("quantize", [False, True])
def test_smoke_prefill_and_decode_match_jax(smoke, quantize):
    """Prefill (B=2, prompt 16) with and without the PQ uplink, then 4
    greedy decode steps fed the reference's tokens: logits and every
    cache within f32 noise of the reference."""
    jmodel, tmodel, jparams, tparams, tokens = smoke
    jc = jmodel.init_caches(B, S + GEN)
    tc = tmodel.init_caches(B, S + GEN, "cpu")
    lg_j, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jc,
                              quantize=quantize)
    lg_t, tc = tmodel.prefill(tparams, {"tokens": _t(tokens).long()}, tc,
                              quantize=quantize)
    assert lg_t.shape == lg_j.shape and lg_t.dtype == torch.float32
    _close(lg_t, lg_j)
    _close_caches(tc, jc)
    for i in range(GEN):
        nxt = np.asarray(jnp.argmax(lg_j[..., :jmodel.cfg.vocab_size], -1)
                         ).astype(np.int32)
        lg_j, jc = jmodel.decode_step(jparams, jc, jnp.asarray(nxt), S + i)
        lg_t, tc = tmodel.decode_step(tparams, tc, _t(nxt).long(), S + i)
        _close(lg_t, lg_j)
    _close_caches(tc, jc)


def test_smoke_cut_codes_match_jax(smoke):
    """The cut activation of each client (sequence) and its PQ codes and
    distortion: FPS seeding with no key is deterministic, so the codes are
    equal (this input has no near-tie, where the order of the f32 sums
    could pick the other code)."""
    jmodel, tmodel, jparams, tparams, tokens = smoke
    acts_j, _, _ = jmodel.client_forward(
        jparams["client"], {"tokens": jnp.asarray(tokens)}, mode="train")
    acts_t, _, _ = tmodel.client_forward(
        tparams["client"], {"tokens": _t(tokens).long()}, mode="train")
    _close(acts_t, acts_j)
    qb = tquantize(_t(np.asarray(acts_j)), tmodel.pq)
    for b in range(B):
        jq = jquantize(acts_j[b], jmodel.pq)
        np.testing.assert_array_equal(qb.codes[b].numpy(),
                                      np.asarray(jq.codes))
        _close(qb.dequantized[b], jq.dequantized)
        _close(qb.distortion[b], jq.distortion, rtol=1e-5, atol=0)
    z_j, st_j = jmodel.cut_activation(acts_j, quantize=True)
    z_t, st_t = tmodel.cut_activation(acts_t, quantize=True)
    _close(z_t, z_j)
    assert st_t["pq_message_bits"] == st_j["pq_message_bits"]
    assert st_t["pq_compression_ratio"] == st_j["pq_compression_ratio"]
    _close(st_t["pq_distortion"], st_j["pq_distortion"], rtol=1e-5, atol=0)


def test_smoke_prefill_then_decode_equals_full_forward(smoke):
    """The twin of tests/test_archs.py's decode check: prefill(S−1) and a
    decode step at S−1 give the full forward's last logits (no quantizer),
    and both match the reference's full forward."""
    jmodel, _, jparams, tparams, tokens = smoke
    tmodel = TransformerLM(tllama.SMOKE_CONFIG)
    batch = {"tokens": _t(tokens).long()}
    acts, _, _ = tmodel.client_forward(tparams["client"], batch, mode="train")
    x, _, _ = tmodel.server_forward(tparams["server"], acts, batch,
                                    mode="train")
    lg_full = tmodel.logits(tparams, x)[:, -1]
    caches = tmodel.init_caches(B, S + 4, "cpu")
    _, caches = tmodel.prefill(tparams, {"tokens": batch["tokens"][:, :S - 1]},
                               caches)
    lg_dec, _ = tmodel.decode_step(tparams, caches,
                                   batch["tokens"][:, S - 1:], S - 1)
    _close(lg_dec[:, 0], lg_full)
    ja, _, _ = jmodel.client_forward(jparams["client"],
                                     {"tokens": jnp.asarray(tokens)})
    jx, _, _ = jmodel.server_forward(jparams["server"], ja,
                                     {"tokens": jnp.asarray(tokens)})
    _close(lg_full, jmodel.logits(jparams, jx)[:, -1])


def test_smoke_prefill_routes_attention_through_flash(smoke, monkeypatch):
    """Default positions: every prefill attention layer takes the flash
    route (here its plain version), the full forward none."""
    _, tmodel, _, tparams, tokens = smoke
    calls = []
    real = tattn.flash_prefill_attention
    monkeypatch.setattr(tattn, "flash_prefill_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    batch = {"tokens": _t(tokens).long()}
    tmodel.client_forward(tparams["client"], batch, mode="train")
    assert calls == []
    tmodel.prefill(tparams, batch, tmodel.init_caches(B, S, "cpu"))
    assert len(calls) == tmodel.cfg.num_layers


def test_full_config_on_meta_matches_reference_shapes():
    """The full llama3_8b on the meta device: every parameter's shape and
    dtype equal the reference's (``jax.eval_shape``, nothing allocated),
    and the count is ``param_count()`` plus the final norm."""
    jmodel = jmake_model(jllama.CONFIG)
    tmodel = tmake_model(tllama.CONFIG)
    jshapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    params = tmodel.init(None, "meta")
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                       params)
    assert got == jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                               jshapes)
    n = sum(t.numel() for t in jax.tree.leaves(params))
    cfg = tllama.CONFIG
    assert n == cfg.param_count() + cfg.d_model
    assert params["client"]["layers"]["p0"]["mixer"]["wq"].shape == \
        (cfg.cut_periods, cfg.d_model, cfg.q_dim)
    assert params["server"]["head"].shape == (cfg.d_model, 128_256)
    caches = tmodel.init_caches(4, 2080, "meta")
    assert caches["server"]["p0"]["k"].shape == (28, 4, 2080, 8, 128)
    assert caches["server"]["p0"]["k"].dtype == torch.bfloat16


def test_lm_training_is_not_ported(smoke):
    """Once the LM's loss raised, naming ROADMAP A15; it is ported now:
    ``loss`` equals the reference's within rtol 1e-5, and ``chunked_ce``,
    ``token_ce`` and ``_ce_sum`` agree with one another
    (tests/test_torch_lm_*.py hold the rest)."""
    jmodel, tmodel, jparams, tparams, tokens = smoke
    labels = np.concatenate([tokens[:, 1:], np.full((B, 1), -1, np.int32)],
                            axis=1)
    tb = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    lt, mt = tmodel.loss(tparams, tb, quantize=False)
    lj, _ = jmodel.loss(jparams, {"tokens": jnp.asarray(tokens),
                                  "labels": jnp.asarray(labels)},
                        quantize=False)
    _close(lt, lj, rtol=1e-5, atol=0)
    acts, _, _ = tmodel.client_forward(tparams["client"], tb)
    x, _, _ = tmodel.server_forward(tparams["server"], acts, tb)
    lg = tmodel.logits(tparams, x)
    ce = tmodel.token_ce(lg, tb["labels"])
    _close(ce, mt["ce"], rtol=1e-6, atol=0)
    _close(tmodel.chunked_ce(tparams, x, tb["labels"], chunk=8), ce,
           rtol=1e-6, atol=0)
    _close(tmodel._ce_sum(lg, tb["labels"]) / (B * (S - 1)), ce, rtol=1e-6,
           atol=0)


def test_serve_cli_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3_8b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--gen", "3"],
        env=env, cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-1500:]
    assert "prefill:" in p.stdout and "decode:" in p.stdout
    assert "uplink per client" in p.stdout
