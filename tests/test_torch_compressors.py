"""Parity of the port's cut-layer compressors and their hooks with the JAX
package: every compressor spec (recon, residual, payload, spec string,
analytic bits), error feedback, the gradients of the uplink and downlink
hooks against ``jax.vjp``, and FEMNIST train steps with the chain downlink
and a carried ``CutState``.

The port compresses C clients in one call (a leading client axis); the
reference compresses one client per call (it vmaps over clients), so each
client of the port is held against one JAX call on that client. The JAX
side runs its ``"jnp"`` backend, the port plain PyTorch on the CPU; inputs
come from a numpy seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jC
from repro.core.fedlite import TrainState as JTrainState
from repro.core.fedlite import make_train_step as j_make_train_step
from repro.core.quantizer import PQConfig as JPQConfig
from repro.data.synthetic import make_federated_image_data as j_image_data
from repro.models.paper_models import FemnistCNN as JFemnistCNN
from repro.optim import sgd as jsgd
from repro_torch.core import compressors as tC
from repro_torch.core.fedlite import TrainState, make_train_step
from repro_torch.core.quantizer import PQConfig
from repro_torch.models.paper_models import FemnistCNN, from_jax_params
from repro_torch.optim import sgd

JPQ = JPQConfig(num_subvectors=8, num_clusters=4, kmeans_iters=2,
                backend="jnp")
TPQ = PQConfig(num_subvectors=8, num_clusters=4, kmeans_iters=2,
               backend="torch")
SPECS = ["none", "pq", "topk(k=0.1)", "scalarq(bits=8)",
         "chain:topk(k=0.1)+scalarq(bits=8)"]
CHAIN = "chain:topk(k=0.1)+scalarq(bits=8)"
LR = 10 ** -1.5
# recon, residual and gradients: f32 noise of the two frameworks
TOL = dict(rtol=1e-6, atol=1e-6)


def _z(seed, shape=(2, 12, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(spec):
    return (tC.make_compressor(spec, pq=TPQ),
            jC.make_compressor(spec, pq=JPQ))


def _assert_payload(tp, jp, c):
    """Client ``c`` of the port's payload against the reference's."""
    if type(jp) is tuple:                      # a chain's stage payloads
        assert type(tp) is tuple and len(tp) == len(jp)
        for a, b in zip(tp, jp):
            _assert_payload(a, b, c)
    elif isinstance(jp, jC.DensePayload):
        np.testing.assert_array_equal(tp.values[c].numpy(),
                                      np.asarray(jp.values))
    elif isinstance(jp, jC.SparsePayload):
        assert tp.indices.dtype == torch.int32
        np.testing.assert_array_equal(tp.indices[c].numpy(),
                                      np.asarray(jp.indices))
        np.testing.assert_allclose(tp.values[c].numpy(),
                                   np.asarray(jp.values), **TOL)
    elif isinstance(jp, jC.ScalarPayload):
        assert tp.codes.dtype == torch.int32
        np.testing.assert_array_equal(tp.codes[c].numpy(),
                                      np.asarray(jp.codes))
        assert float(tp.lo[c]) == float(jp.lo)
        assert float(tp.scale[c]) == float(jp.scale)
    else:                                      # a QuantizedBatch
        np.testing.assert_array_equal(tp.codes[c].numpy(),
                                      np.asarray(jp.codes))
        np.testing.assert_allclose(tp.codebooks[c].numpy(),
                                   np.asarray(jp.codebooks), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(float(tp.distortion[c]),
                                   float(jp.distortion), rtol=1e-5)


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", SPECS)
def test_compressor_matches_jax(spec):
    """Recon, residual and payload per client; spec and analytic bits."""
    tc, jc = _pair(spec)
    assert tc.spec == jc.spec
    for n, d, phi in ((12, 64, 32), (20, 9216, 32), (7, 96, 64)):
        assert tc.analytic_bits(n, d, phi) == jc.analytic_bits(n, d, phi)
        assert tc.overhead_bits(n, d, phi) == jc.overhead_bits(n, d, phi)
        assert tc.carrier_elems(n, d) == jc.carrier_elems(n, d)
    z = _z(1)
    comp = tc.compress(torch.from_numpy(z))
    assert comp.recon.shape == z.shape and comp.residual.shape == z.shape
    assert torch.equal(comp.residual, torch.from_numpy(z) - comp.recon)
    assert torch.equal(tc.decompress(comp), comp.recon)
    for c in range(2):
        ref = jc.compress(jnp.asarray(z[c]))
        np.testing.assert_allclose(comp.recon[c].numpy(),
                                   np.asarray(ref.recon), **TOL)
        np.testing.assert_allclose(comp.residual[c].numpy(),
                                   np.asarray(ref.residual), **TOL)
        _assert_payload(comp.payload, ref.payload, c)


def test_topk_keeps_each_clients_largest_and_lower_index_on_ties():
    z = np.zeros((2, 4, 4), np.float32)
    z[0] = np.arange(1.0, 17.0).reshape(4, 4) * np.array([1, -1] * 8
                                                         ).reshape(4, 4)
    z[1, 0, :3] = 5.0                   # a three-way tie for two slots
    comp = tC.TopKCompressor(k=0.125).compress(torch.from_numpy(z))
    np.testing.assert_array_equal(comp.payload.indices.numpy(),
                                  [[14, 15], [0, 1]])
    ref = jC.TopKCompressor(k=0.125).compress(jnp.asarray(z[1]))
    np.testing.assert_array_equal(np.asarray(ref.payload.indices), [0, 1])
    np.testing.assert_array_equal(comp.recon[1].numpy(), np.asarray(
        ref.recon))


def test_scalarq_ranges_are_per_client_and_constant_inputs_exact():
    z = _z(2)
    z[1] = 0.25                          # hi == lo: scale 1, codes 0
    comp = tC.ScalarQuantCompressor(bits=4).compress(torch.from_numpy(z))
    lo, scale = comp.payload.lo, comp.payload.scale
    assert lo.shape == (2,) and float(scale[1]) == 1.0
    assert float(lo[0]) == float(z[0].min())
    np.testing.assert_array_equal(comp.payload.codes[1].numpy(), 0)
    np.testing.assert_array_equal(comp.recon[1].numpy(), z[1])
    # nearest rounding: within half a step of the input everywhere
    assert float(comp.residual[0].abs().max()) <= float(scale[0]) / 2 + 1e-6


@pytest.mark.parametrize("bits", [4, 8])
def test_scalarq_bf16_matches_jax(bits):
    """A bf16 z against the JAX compressor ("jnp") on the same bf16 values:
    the range (lo, scale) and the codes equal; recon and residual (bf16)
    within one bf16 rounding (both round lo + codes·scale from f32, XLA
    through an FMA); and bitwise the port on the f32 upcast, its recon
    rounded to bf16."""
    zb = torch.from_numpy(_z(bits)).to(torch.bfloat16)
    zb[1, 0] = 0.0
    tc = tC.ScalarQuantCompressor(bits=bits, backend="torch")
    jc = jC.ScalarQuantCompressor(bits=bits, backend="jnp")
    comp = tc.compress(zb)
    assert comp.recon.dtype == torch.bfloat16
    up = tc.compress(zb.float())
    assert torch.equal(comp.payload.codes, up.payload.codes)
    assert torch.equal(comp.payload.lo, up.payload.lo)
    assert torch.equal(comp.payload.scale, up.payload.scale)
    assert torch.equal(comp.recon, up.recon.to(torch.bfloat16))
    for c in range(2):
        ref = jc.compress(jnp.asarray(zb[c].float().numpy()).astype(
            jnp.bfloat16))
        _assert_payload(comp.payload, ref.payload, c)
        for mine, theirs in ((comp.recon, ref.recon),
                             (comp.residual, ref.residual)):
            np.testing.assert_allclose(
                mine[c].float().numpy(),
                np.asarray(theirs.astype(jnp.float32)), rtol=2.0 ** -8,
                atol=1e-6)


def test_scalarq_kernel_path_gets_z_unconverted(monkeypatch):
    """On the kernel path ("cuda", or "auto" on a CUDA tensor) compress
    hands ops.scalar_quantize a view of z itself (a bf16 z stays bf16, no
    f32 copy), with an f32 range."""
    seen = {}

    def record(x, lo, scale, bits):
        seen.update(x=x, lo=lo, scale=scale)
        return tC.ref.scalar_quantize_ref(x, lo, scale, bits)

    monkeypatch.setattr(tC.ops, "use_kernel",
                        lambda t, backend="auto": backend != "torch")
    monkeypatch.setattr(tC.ops, "scalar_quantize", record)
    zb = torch.from_numpy(_z(5)).to(torch.bfloat16)
    comp = tC.ScalarQuantCompressor(bits=8).compress(zb)
    assert seen["x"].dtype == torch.bfloat16
    assert seen["x"].data_ptr() == zb.data_ptr()
    assert seen["x"].shape == (2, zb[0].numel())
    assert seen["lo"].dtype == seen["scale"].dtype == torch.float32
    ref = tC.ScalarQuantCompressor(bits=8, backend="torch").compress(zb)
    assert torch.equal(comp.recon, ref.recon)
    assert torch.equal(comp.payload.codes, ref.payload.codes)


def test_spec_parser_and_registry_match_jax():
    assert tC.available_compressors() == jC.available_compressors()
    assert isinstance(tC.make_compressor("none"), tC.NoneCompressor)
    c = tC.make_compressor("chain:topk(k=0.5)+scalarq(bits=4, backend=torch)")
    assert isinstance(c, tC.ChainCompressor)
    assert c.stages[0].k == 0.5 and c.stages[1].bits == 4
    assert c.stages[1].backend == "torch"
    assert tC.make_compressor(c) is c and tC.make_compressor(None) is None
    for bad in ("nosuch(k=1)", "pq", "chain:scalarq(bits=8)+topk(k=0.1)",
                "topk(k=1.5)", "scalarq(bits=17)",
                "scalarq(bits=8, backend=jnp)", "topk(0.1)"):
        with pytest.raises(ValueError):
            tC.make_compressor(bad)
    assert tC.make_compressor("pq", pq=TPQ).cfg is TPQ
    assert tC.index_bits(184320) == jC.index_bits(184320) == 18
    assert tC.index_bits(1) == jC.index_bits(1) == 1


def test_error_feedback_matches_jax_and_telescopes():
    """EF over 6 rounds tracks the reference's, and nothing is lost:
    recon + memory' == z + memory."""
    tef = tC.ErrorFeedback(tC.TopKCompressor(k=0.125))
    jef = jC.ErrorFeedback(jC.TopKCompressor(k=0.125))
    z = _z(3, (2, 4, 16))
    zt = torch.from_numpy(z)
    mem = tef.init_memory(zt)
    jmem = [jef.init_memory(jnp.asarray(z[c])) for c in range(2)]
    sent = torch.zeros_like(zt)
    for _ in range(6):
        comp, new = tef.step(zt, mem)
        assert torch.allclose(comp.recon + new, zt + mem, rtol=1e-6,
                              atol=1e-6)
        for c in range(2):
            jcomp, jmem[c] = jef.step(jnp.asarray(z[c]), jmem[c])
            np.testing.assert_allclose(comp.recon[c].numpy(),
                                       np.asarray(jcomp.recon), **TOL)
            np.testing.assert_allclose(new[c].numpy(), np.asarray(jmem[c]),
                                       **TOL)
        mem, sent = new, sent + comp.recon
    np.testing.assert_allclose((sent + mem).numpy(), 6.0 * z, rtol=1e-5,
                               atol=1e-5)
    none = tC.ErrorFeedback(tC.NoneCompressor())
    comp, m = none.step(zt, none.init_memory(zt))
    assert torch.equal(comp.recon, zt) and float(m.abs().max()) == 0.0


def test_wire_payload_waits_for_the_wire_port():
    """The wire port has landed: ``wire_payload`` of each client is the
    reference's frame of that client's tensor, byte for byte."""
    c = tC.make_compressor("topk(k=0.1)")
    jc = jC.make_compressor("topk(k=0.1)")
    z = _z(4)
    comp = c.compress(torch.from_numpy(z))
    for client in range(z.shape[0]):
        assert c.wire_payload(comp, client=client) == \
            jc.wire_payload(jc.compress(jnp.asarray(z[client])))


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["pq", "topk(k=0.1)", "scalarq(bits=8)",
                                  CHAIN])
def test_compress_with_correction_grad_matches_jax(spec):
    tc, jc = _pair(spec)
    z, g = _z(5), _z(6)
    zt = torch.from_numpy(z).requires_grad_()
    out, dist = tC.compress_with_correction_stats(zt, 0.3, tc)
    assert not dist.requires_grad and dist.shape == (2,)
    (grad,) = torch.autograd.grad(out, zt, torch.from_numpy(g))
    out1 = tC.compress_with_correction(zt, 0.3, tc)
    assert torch.equal(out1, out)
    for c in range(2):
        (o_j, d_j), vjp = jax.vjp(
            lambda v: jC.compress_with_correction_stats(v, 0.3, jc),
            jnp.asarray(z[c]))
        np.testing.assert_allclose(out[c].detach().numpy(), np.asarray(o_j),
                                   **TOL)
        np.testing.assert_allclose(float(dist[c]), float(d_j), rtol=1e-5)
        gj = vjp((jnp.asarray(g[c]), jnp.zeros(())))[0]
        np.testing.assert_allclose(grad[c].numpy(), np.asarray(gj), **TOL)


def test_compress_with_correction_carry_matches_jax():
    """Two rounds of the carrying hook with PQ and error feedback: recon,
    distortion, the new state (codebooks, rounds, EF memory) and the eq.-5
    gradient, round by round, against the reference on each client."""
    tc, jc = tC.PQCompressor(TPQ), jC.PQCompressor(JPQ)
    z0 = _z(7)
    state = tC.CutState(quantizer=None,
                        ef_memory=torch.zeros_like(torch.from_numpy(z0)))
    jstate = [jC.CutState(quantizer=None, ef_memory=jnp.zeros(z0.shape[1:]))
              for _ in range(2)]
    for rnd in range(2):
        z, g = _z(8 + rnd), _z(10 + rnd)
        zt = torch.from_numpy(z).requires_grad_()
        out, dist, new = tC.compress_with_correction_carry(zt, 1e-2, state,
                                                           tc)
        assert not any(t.requires_grad for t in
                       (dist, new.ef_memory, *new.quantizer))
        (grad,) = torch.autograd.grad(out, zt, torch.from_numpy(g))
        np.testing.assert_array_equal(new.quantizer.rounds.numpy(),
                                      [rnd + 1] * 2)
        for c in range(2):
            (o_j, d_j, s_j), vjp = jax.vjp(
                lambda v: jC.compress_with_correction_carry(v, 1e-2,
                                                            jstate[c], jc),
                jnp.asarray(z[c]))
            np.testing.assert_allclose(out[c].detach().numpy(),
                                       np.asarray(o_j), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(float(dist[c]), float(d_j),
                                       rtol=1e-5)
            np.testing.assert_allclose(new.quantizer.codebooks[c].numpy(),
                                       np.asarray(s_j.quantizer.codebooks),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(new.ef_memory[c].numpy(),
                                       np.asarray(s_j.ef_memory), rtol=1e-5,
                                       atol=1e-5)
            cot = (jnp.asarray(g[c]), jnp.zeros(()),
                   jax.tree.map(jnp.zeros_like, s_j))
            np.testing.assert_allclose(grad[c].numpy(),
                                       np.asarray(vjp(cot)[0]), rtol=1e-5,
                                       atol=1e-5)
            jstate[c] = s_j
        state = new
    # stateless codecs carry no quantizer state; without EF, no memory
    out, _, new = tC.compress_with_correction_carry(
        torch.from_numpy(_z(12)), 0.0, tC.CutState(),
        tC.make_compressor("topk(k=0.1)"))
    assert new == tC.CutState()


@pytest.mark.parametrize("spec", ["pq", "topk(k=0.1)", "scalarq(bits=8)",
                                  CHAIN])
def test_compress_downlink_grad_matches_jax(spec):
    """Identity forward; the cotangent is compressed per client."""
    tc, jc = _pair(spec)
    z, g = _z(13), _z(14)
    zt = torch.from_numpy(z).requires_grad_()
    out = tC.compress_downlink(zt, tc)
    assert torch.equal(out.detach(), zt.detach())
    (grad,) = torch.autograd.grad(out, zt, torch.from_numpy(g))
    assert torch.equal(grad, tc.compress(torch.from_numpy(g)).recon)
    for c in range(2):
        o_j, vjp = jax.vjp(lambda v: jC.compress_downlink(v, jc),
                           jnp.asarray(z[c]))
        np.testing.assert_array_equal(np.asarray(o_j), z[c])
        np.testing.assert_allclose(grad[c].numpy(),
                                   np.asarray(vjp(jnp.asarray(g[c]))[0]),
                                   **TOL)


def test_downlink_none_is_bitwise_identity():
    """A "none" downlink hands the cotangent back untouched, on every hook
    (the uncompressed backward pass, bit for bit)."""
    none = tC.NoneCompressor()
    z = torch.from_numpy(_z(15)).requires_grad_()
    plain = torch.autograd.grad(torch.sin(z).square().sum(), z)[0]
    hooks = (lambda v: tC.compress_downlink(v, none),
             lambda v: tC.compress_downlink_keyed(
                 v, torch.Generator().manual_seed(0), none),
             lambda v: tC.compress_downlink_stateful(v, None, none))
    for hook in hooks:
        hooked = torch.autograd.grad(torch.sin(hook(z)).square().sum(), z)[0]
        assert torch.equal(hooked, plain)


def test_compress_downlink_stateful_matches_jax():
    """A pq downlink resumes from last round's (per-client) codebooks."""
    tc, jc = tC.PQCompressor(TPQ), jC.PQCompressor(JPQ)
    _, state = tc.compress_stateful(torch.from_numpy(_z(16)))
    z, g = _z(17), _z(18)
    zt = torch.from_numpy(z).requires_grad_()
    (grad,) = torch.autograd.grad(tC.compress_downlink_stateful(zt, state,
                                                                tc),
                                  zt, torch.from_numpy(g))
    cold = tC.compress_downlink(zt, tc)
    (grad_cold,) = torch.autograd.grad(cold, zt, torch.from_numpy(g))
    assert not torch.equal(grad, grad_cold)
    for c in range(2):
        _, jstate = jc.compress_stateful(jnp.asarray(_z(16)[c]))
        _, vjp = jax.vjp(lambda v: jC.compress_downlink_stateful(v, jstate,
                                                                 jc),
                         jnp.asarray(z[c]))
        np.testing.assert_allclose(grad[c].numpy(),
                                   np.asarray(vjp(jnp.asarray(g[c]))[0]),
                                   rtol=1e-5, atol=1e-5)


def test_keyed_downlink_rounds_stochastically_and_unbiased():
    """With a generator, scalarq rounds each value to one of its two
    neighbouring levels, and the mean over many draws approaches the
    cotangent. (``jax.random`` cannot be reproduced: a property test.)"""
    sq = tC.ScalarQuantCompressor(bits=4)
    g = torch.from_numpy(_z(19, (2, 4, 16)))
    z = torch.zeros_like(g).requires_grad_()
    gen = torch.Generator().manual_seed(0)
    outs = []
    for _ in range(200):
        out = tC.compress_downlink_keyed(z, gen, sq)
        outs.append(torch.autograd.grad(out, z, g)[0])
    nearest = sq.compress(g)
    scale = nearest.payload.scale[:, None, None]
    for o in outs[:3]:
        assert float(((o - g).abs() / scale).max()) < 1.0 + 1e-5
    assert not torch.equal(outs[0], outs[1])
    mean = torch.stack(outs).mean(0)
    assert float(((mean - g).abs() / scale).max()) < 0.2


# ---------------------------------------------------------------------------
# FEMNIST steps
# ---------------------------------------------------------------------------

def _femnist_pair(downlink, client_batch=4):
    jpq = JPQConfig(1152, 2, kmeans_iters=5, backend="jnp")
    tpq = PQConfig(1152, 2, kmeans_iters=5, backend="torch")
    jm = JFemnistCNN(pq=jpq, lam=1e-4, client_batch=client_batch,
                     downlink_compressor=jC.make_compressor(downlink))
    tm = FemnistCNN(pq=tpq, lam=1e-4, client_batch=client_batch,
                    downlink_compressor=downlink, device="cpu")
    params = jax.tree.map(np.asarray, JFemnistCNN().init(
        jax.random.PRNGKey(0)))
    tm.load_state_dict(from_jax_params(params))
    return jm, tm, params


def _batch(seed, batch=8, clients=2):
    data = j_image_data(num_clients=8, seed=0)
    keys = jax.random.split(jax.random.PRNGKey(seed), clients)
    parts = [data.sample_batch(c, keys[c], batch // clients)
             for c in range(clients)]
    b = {k: np.concatenate([np.asarray(p[k]) for p in parts])
         for k in parts[0]}
    return b, {"image": torch.from_numpy(b["image"]),
               "label": torch.from_numpy(b["label"].astype(np.int64))}


@pytest.fixture
def _full_f32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved


def test_chain_downlink_warm_start_steps_track_jax(_full_f32):
    """3 steps at 2 clients x 4 with the chain downlink and a carried
    CutState: step 1 cold (5 Lloyd iterations), then warm (2); the loss
    tracks the reference's step for step within 1e-4, and the carried
    codebooks and round counters match."""
    jm, tm, params = _femnist_pair(CHAIN)
    jstep = j_make_train_step(jm, jsgd(LR), donate=False)
    tstep = make_train_step(tm, sgd(LR))
    js = JTrainState.create(jax.tree.map(jnp.asarray, params), jsgd(LR))
    ts = TrainState.create(dict(tm.named_parameters()), sgd(LR))
    jcut, tcut = jC.CutState(), tC.CutState()
    for i in range(3):
        jb, tb = _batch(20 + i)
        js, met_j = jstep(js, jb, jcut)
        ts, met_t = tstep(ts, tb, tcut)
        jcut, tcut = met_j.pop("cut_state"), met_t.pop("cut_state")
        assert abs(float(met_t["loss"]) - float(met_j["loss"])) <= 1e-4
        np.testing.assert_allclose(float(met_t["pq_distortion"]),
                                   float(met_j["pq_distortion"]), rtol=1e-4)
        np.testing.assert_array_equal(tcut.quantizer.rounds.numpy(),
                                      np.asarray(jcut.quantizer.rounds))
        np.testing.assert_allclose(tcut.quantizer.codebooks.numpy(),
                                   np.asarray(jcut.quantizer.codebooks),
                                   rtol=1e-4, atol=1e-5)
        assert tcut.ef_memory is None
    for part, leaves in js.params.items():
        ref = from_jax_params({part: jax.tree.map(np.asarray, leaves)})
        for k, v in ref.items():
            np.testing.assert_allclose(ts.params[k].detach().numpy(),
                                       v.numpy(), rtol=0, atol=1e-4,
                                       err_msg=k)


def test_error_feedback_cut_state_keeps_the_cut_layout(_full_f32):
    """EF memory in the (B, d) layout goes in and comes back out, per
    client, as in the reference (its new memory is the PQ residual)."""
    jm, tm, params = _femnist_pair("none")
    jb, tb = _batch(30)
    mem = np.zeros((8, 9216), np.float32)
    loss_j, met_j = jm.loss(jax.tree.map(jnp.asarray, params), jb,
                            cut_state=jC.CutState(ef_memory=jnp.asarray(
                                mem)))
    loss_t, met_t = tm(tb, cut_state=tC.CutState(
        ef_memory=torch.from_numpy(mem)))
    assert abs(float(loss_t.detach()) - float(loss_j)) <= 1e-4
    ef_t, ef_j = met_t["cut_state"].ef_memory, met_j["cut_state"].ef_memory
    assert ef_t.shape == (8, 9216) and ef_j.shape == (8, 9216)
    np.testing.assert_allclose(ef_t.numpy(), np.asarray(ef_j), rtol=1e-4,
                               atol=1e-4)


def test_downlink_touches_client_grads_only_and_none_is_bitwise(_full_f32):
    """A lossy downlink codec changes client grads (below the cut), not
    server grads (above it); a "none" downlink changes nothing, bitwise."""
    _, plain, _ = _femnist_pair(None)
    _, none, _ = _femnist_pair("none")
    _, chain, _ = _femnist_pair(CHAIN)
    _, tb = _batch(31)
    grads = []
    for m in (plain, none, chain):
        loss, _ = m(tb)
        grads.append(dict(zip(dict(m.named_parameters()),
                              torch.autograd.grad(loss, list(
                                  m.parameters())))))
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k])
        if k.startswith("server."):
            assert torch.equal(grads[0][k], grads[2][k])
    assert any(not torch.equal(grads[0][k], grads[2][k])
               for k in grads[0] if k.startswith("client."))


def test_keyed_step_changes_only_client_grads(_full_f32):
    """A step_key makes the scalarq downlink round stochastically: keyed
    steps under two seeds move the client weights apart and leave the
    server weights as the keyless step leaves them; the keyless step is
    deterministic and tracks the reference's keyless step."""
    jm, tm, params = _femnist_pair("scalarq(bits=4)", client_batch=0)
    jb, tb = _batch(32, batch=4, clients=1)
    opt = sgd(LR)
    state = TrainState.create(dict(tm.named_parameters()), opt)
    plain = make_train_step(tm, opt)
    s_a, met_a = plain(state, tb)
    s_b, _ = plain(state, tb)
    for k in s_a.params:
        assert torch.equal(s_a.params[k], s_b.params[k])
    js = JTrainState.create(jax.tree.map(jnp.asarray, params), jsgd(LR))
    _, met_j = j_make_train_step(jm, jsgd(LR), donate=False)(js, jb)
    assert abs(float(met_a["loss"]) - float(met_j["loss"])) <= 1e-4
    keyed = [make_train_step(tm, opt, step_key=s)(state, tb)[0]
             for s in (7, 8, 7)]
    for k in state.params:
        if k.startswith("server."):
            assert torch.equal(keyed[0].params[k], s_a.params[k])
            assert torch.equal(keyed[1].params[k], s_a.params[k])
        assert torch.equal(keyed[0].params[k], keyed[2].params[k])
    assert any(not torch.equal(keyed[0].params[k], keyed[1].params[k])
               for k in state.params if k.startswith("client."))
