"""Parity of the port's wire codec (``repro_torch/federated/wire.py``) with
the JAX package's: the frames are framework-free bytes, so every kind must
be byte-identical to the reference's on the same content, each side must
decode the other's frames, legacy frames must decode, and corruptions must
raise the same typed ``WireError`` subclass.

Where a compressor draws the content (PQ codebooks differ from the
reference's by f32 summation-order ulps, which the parity policy allows),
the reference encodes the port's own codes and codebooks, so the bytes are
compared on identical content. Tolerance: none; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jC
from repro.core.quantizer import PQConfig as JPQConfig
from repro.core.quantizer import QuantizedBatch as JQuantizedBatch
from repro.federated import wire as jw
from repro_torch.core import compressors as tC
from repro_torch.core.quantizer import PQConfig, quantize, quantize_stateful
from repro_torch.federated import wire as tw

DTYPES = ["float16", "float32", "bfloat16"]


def _z(seed, n, d, clients=1):
    return np.random.default_rng(seed).standard_normal(
        (clients, n, d)).astype(np.float32)


def _port_qb(q=8, L=5, r=1, n=24, d=64, seed=0, clients=1):
    cfg = PQConfig(q, L, num_groups=r, kmeans_iters=3, backend="torch")
    return quantize(torch.from_numpy(_z(seed, n, d, clients)), cfg), cfg


def _ref_qb(qb, client=0):
    """The reference's QuantizedBatch holding the port's client ``client``."""
    return JQuantizedBatch(
        dequantized=jnp.asarray(qb.dequantized[client].float().numpy()),
        codes=jnp.asarray(qb.codes[client].numpy()),
        codebooks=jnp.asarray(qb.codebooks[client].float().numpy()),
        distortion=jnp.asarray(qb.distortion[client].numpy()),
        residual=jnp.asarray(qb.residual[client].float().numpy()))


def _jcfg(cfg):
    return JPQConfig(cfg.q, cfg.l, num_groups=cfg.r,
                     kmeans_iters=cfg.kmeans_iters)


# ---------------------------------------------------------------------------
# bytes equal the reference's, kind by kind
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("geom", [(8, 5, 1), (16, 2, 2), (8, 1, 1),
                                  (8, 16, 4)])
def test_pq_bytes_equal_reference(geom, dtype):
    q, L, r = geom
    qb, _ = _port_qb(q, L, r)
    jqb = _ref_qb(qb)
    ours = tw.encode_bytes(qb, dtype)
    assert ours == jw.encode_bytes(jqb, dtype)
    # each side decodes the other's frame to the same codes and codebooks
    a, b = tw.decode_bytes(jw.encode_bytes(jqb, dtype)), jw.decode_bytes(ours)
    np.testing.assert_array_equal(a.codes, np.asarray(b.codes))
    np.testing.assert_array_equal(
        a.codebooks, np.asarray(b.codebooks, np.float32))
    assert (a.n, a.d, a.dtype) == (b.n, b.d, dtype)
    np.testing.assert_array_equal(tw.dequantize(a),
                                  np.asarray(jw.dequantize(b), np.float32))
    assert tw.payload_kind(ours) == "pq"


def test_pq_bytes_of_a_bf16_batch_and_of_each_client():
    """Codebooks held in bf16 (the serve cut's) and a batch of several
    clients: client c's frame is the reference's frame of that client."""
    z = torch.from_numpy(_z(3, 24, 64, clients=3))
    cfg = PQConfig(8, 4, kmeans_iters=3, backend="torch")
    qb = quantize(z.to(torch.bfloat16), cfg)
    assert qb.codebooks.dtype == torch.bfloat16
    for c in range(3):
        for dtype in DTYPES:
            jqb = _ref_qb(qb, c)._replace(codebooks=jnp.asarray(
                qb.codebooks[c].float().numpy()).astype(jnp.bfloat16))
            assert tw.encode_bytes(qb, dtype, client=c) == \
                jw.encode_bytes(jqb, dtype)
    with pytest.raises(ValueError, match="client="):
        tw.encode_bytes(qb, "float16")


def test_bf16_rounds_to_nearest_even_as_ml_dtypes():
    """The bf16 encode (through torch.bfloat16) is bitwise the reference's
    ml_dtypes cast, halfway cases, signed zeros and infinities included."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64) \
        .astype(np.uint32)
    ties = (rng.integers(0, 2 ** 16, size=512).astype(np.uint32) << 16) \
        | np.uint32(0x8000)                               # exact halfway
    x = np.concatenate([bits, ties]).view(np.float32)     # NaNs included
    x = np.concatenate([x, np.array([0.0, -0.0, np.inf, -np.inf, 1e-40,
                                     3.3895314e38], np.float32)])
    assert np.isnan(x).any()
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).tobytes()
    assert tw._wire_values(x, "bfloat16") == ref
    assert tw._wire_values(torch.from_numpy(x), "bfloat16") == ref
    back = tw._from_wire(ref, "bfloat16", x.size)
    np.testing.assert_array_equal(
        back, np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("delta_bits", [4, 8])
def test_pq_delta_bytes_and_epoch_equal_reference(delta_bits):
    qb1, cfg = _port_qb(8, 16, 2, seed=1)
    qb2, _ = quantize_stateful(torch.from_numpy(_z(2, 24, 64)), cfg,
                               quantize_stateful(
                                   torch.from_numpy(_z(1, 24, 64)), cfg)[1])
    ref = tw.decode_bytes(tw.encode_bytes(qb1)).codebooks.astype(np.float32)
    ours, recon = tw.encode_pq_delta(qb2, ref, delta_bits, epoch=3)
    theirs, jrecon = jw.encode_pq_delta(_ref_qb(qb2), ref, delta_bits,
                                        epoch=3)
    assert ours == theirs
    np.testing.assert_array_equal(recon, np.asarray(jrecon))
    assert tw.pq_delta_epoch(ours) == jw.pq_delta_epoch(theirs) == 3
    a = tw.decode_pq_delta(theirs, ref, expected_epoch=3)
    b = jw.decode_pq_delta(ours, ref, expected_epoch=3)
    np.testing.assert_array_equal(a.codes, np.asarray(b.codes))
    np.testing.assert_array_equal(a.codebooks, np.asarray(b.codebooks))
    np.testing.assert_array_equal(a.codebooks, recon)
    assert tw.payload_kind(ours) == "pq-delta"
    for mod, payload in ((tw, ours), (jw, theirs)):
        with pytest.raises(mod.WireResyncError, match="epoch 3"):
            mod.decode_pq_delta(payload, ref, expected_epoch=4)
        with pytest.raises(mod.WireResyncError, match="resync"):
            mod.decode_pq_delta(payload, ref[:, :1], expected_epoch=3)
        with pytest.raises(mod.WireError, match="decode_pq_delta"):
            mod.decode_payload(payload)


@pytest.mark.parametrize("wire_dtype", DTYPES)
@pytest.mark.parametrize("source", ["numpy", "torch-f32", "torch-bf16"])
def test_dense_bytes_equal_reference(source, wire_dtype):
    x = _z(4, 6, 10)[0]
    if source == "torch-bf16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        x = t.float().numpy()                 # the values bf16 holds
        ref_in = jnp.asarray(x).astype(jnp.bfloat16)
        ours = tw.encode_dense(t, 6, 10, wire_dtype)
    else:
        ref_in = x
        ours = tw.encode_dense(torch.from_numpy(x) if source == "torch-f32"
                               else x, 6, 10, wire_dtype)
    assert ours == jw.encode_dense(ref_in, 6, 10, wire_dtype)
    # the dtype of the tensor itself names the wire dtype, as jnp's does
    if source == "torch-bf16":
        assert tw.encode_dense(t, 6, 10, t.dtype) == \
            jw.encode_dense(ref_in, 6, 10, ref_in.dtype)


@pytest.mark.parametrize("value_dtype", DTYPES)
def test_sparse_bytes_equal_reference(value_dtype):
    rng = np.random.default_rng(6)
    idx = np.sort(rng.choice(200, size=17, replace=False))
    vals = rng.standard_normal(17).astype(np.float32)
    ours = tw.encode_sparse(torch.from_numpy(idx).int(), 10, 20,
                            values=torch.from_numpy(vals),
                            value_dtype=value_dtype)
    assert ours == jw.encode_sparse(idx, 10, 20, values=vals,
                                    value_dtype=value_dtype)
    scalar = jw.encode_scalar(np.arange(17) % 8, -1.0, 0.25, 3, 17, 1)
    assert tw.encode_sparse(idx, 10, 20, inner=scalar) == \
        jw.encode_sparse(idx, 10, 20, inner=scalar)


@pytest.mark.parametrize("bits", [1, 3, 8, 16])
def test_scalar_bytes_equal_reference(bits):
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, size=(7, 9))
    ours = tw.encode_scalar(torch.from_numpy(codes).int(), -0.75, 0.125,
                            bits, 7, 9)
    assert ours == jw.encode_scalar(codes, -0.75, 0.125, bits, 7, 9)


@pytest.mark.parametrize("spec", ["none", "pq", "topk(k=0.1)",
                                  "scalarq(bits=8)", "scalarq(bits=3)",
                                  "chain:topk(k=0.1)+scalarq(bits=8)",
                                  "chain:none+topk(k=0.2)"])
def test_compressed_payload_equals_reference(spec):
    """``CutCompressor.wire_payload`` (``encode_compressed``, nested chain
    stages included) is the reference's frame for each client's tensor."""
    z = _z(8, 12, 64, clients=2)
    tc = tC.make_compressor(spec, pq=PQConfig(16, 4, kmeans_iters=3,
                                              backend="torch"))
    jc = jC.make_compressor(spec, pq=JPQConfig(16, 4, kmeans_iters=3))
    comp = tc.compress(torch.from_numpy(z))
    for c in range(2):
        jcomp = jc.compress(jnp.asarray(z[c]))
        if spec == "pq":   # same content: the port's codes and codebooks
            jcomp = jcomp._replace(payload=_ref_qb(comp.payload, c))
        for vd in DTYPES:
            ours = tc.wire_payload(comp, value_dtype=vd, client=c)
            assert ours == jc.wire_payload(jcomp, value_dtype=vd)


@pytest.mark.parametrize("spec", ["pq", "topk(k=0.1)",
                                  "chain:topk(k=0.1)+scalarq(bits=8)"])
def test_cohort_payload_needs_a_client(spec):
    """Both encoders take one rule: a result of several clients must name
    whose frame to write (``client=``), and one client's result needs no
    name. Without it a cohort's payload would be its first client's."""
    tc = tC.make_compressor(spec, pq=PQConfig(16, 4, kmeans_iters=3,
                                              backend="torch"))
    z = torch.from_numpy(_z(9, 12, 64, clients=3))
    comp = tc.compress(z)
    with pytest.raises(ValueError, match="3 clients: pass client="):
        tc.wire_payload(comp)
    if spec == "pq":
        with pytest.raises(ValueError, match="3 clients: pass client="):
            tw.encode_bytes(comp.payload)
    one = tc.compress(z[2:])
    assert tc.wire_payload(one) == tc.wire_payload(comp, client=2)


# ---------------------------------------------------------------------------
# decoding: cross, legacy, idempotent
# ---------------------------------------------------------------------------

def _samples():
    """(name, port frame) for every self-describing kind."""
    qb, _ = _port_qb()
    scalar = tw.encode_scalar(np.arange(32).reshape(4, 8) % 4, -1.0, 0.5,
                              2, 4, 8)
    return [
        ("pq", tw.encode_bytes(qb, "float16")),
        ("pq-bf16", tw.encode_bytes(qb, "bfloat16")),
        ("dense", tw.encode_dense(np.ones((4, 8), np.float32), 4, 8)),
        ("dense-bf16", tw.encode_dense(np.linspace(-2, 2, 32), 4, 8,
                                       "bfloat16")),
        ("sparse", tw.encode_sparse(np.array([0, 3, 17]), 4, 8,
                                    values=np.array([1., 2., 3.]))),
        ("sparse-nested", tw.encode_sparse(
            np.array([1, 5, 9]), 4, 8,
            inner=tw.encode_scalar(np.array([3, 0, 2]), -1.0, 0.5, 2, 3,
                                   1))),
        ("scalar", scalar),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _samples()])
def test_each_side_decodes_the_others_frames(name):
    payload = dict(_samples())[name]
    ours, theirs = tw.decode_payload(payload), jw.decode_payload(payload)
    assert (ours.kind, ours.n, ours.d, ours.bits) == \
        (theirs.kind, theirs.n, theirs.d, theirs.bits)
    np.testing.assert_array_equal(tw.reconstruct(ours),
                                  np.asarray(jw.reconstruct(theirs)))
    # a re-encode of the decode is byte-identical, on both sides
    assert tw.encode_decoded(ours) == payload == jw.encode_decoded(theirs)
    assert tw.encode_decoded(tw.decode_payload(jw.encode_decoded(theirs))) \
        == payload


@pytest.mark.parametrize("version", [1, 2, 3])
def test_legacy_frames_decode(version):
    """Pre-v4 frames written by the reference decode in the port, and the
    port's downgrade helper writes the same legacy bytes."""
    for name, payload in _samples():
        if version == 1 and not name.startswith("pq"):
            continue
        legacy = jw._legacy_frame(payload, version)
        assert tw._legacy_frame(payload, version) == legacy
        np.testing.assert_array_equal(
            tw.reconstruct(tw.decode_payload(legacy)),
            np.asarray(jw.reconstruct(jw.decode_payload(legacy))))
    qb, cfg = _port_qb(8, 4, 1, seed=9)
    ref = np.zeros(cfg.codebook_shape(64), np.float32)
    delta, _ = tw.encode_pq_delta(qb, ref, 8, epoch=2)
    if version == 3:
        legacy = jw._legacy_frame(delta, 3)
        a = tw.decode_pq_delta(legacy, ref, expected_epoch=9)  # no epoch
        b = jw.decode_pq_delta(legacy, ref)
        np.testing.assert_array_equal(a.codebooks, np.asarray(b.codebooks))
        with pytest.raises(tw.WireVersionError):
            tw.pq_delta_epoch(legacy)


def _outcome(decode, frame):
    try:
        decode(frame)
    except Exception as e:  # the class name is the outcome compared
        return type(e).__name__
    return "ok"


def _corruptions(payload, rng):
    out = [payload[:cut] for cut in
           sorted({0, 1, 23, 24, len(payload) - 1,
                   *rng.integers(0, len(payload), size=6).tolist()})]
    for bitpos in rng.choice(len(payload) * 8, size=24, replace=False):
        buf = bytearray(payload)
        buf[bitpos // 8] ^= 1 << (bitpos % 8)
        out.append(bytes(buf))
    out += [payload + payload, payload + b"\x00\x01\x02\x03",
            b"XXXX" + payload[4:]]
    for pos, value in ((4, 9), (7, 9), (5, 7)):   # version, kind, dtype code
        buf = bytearray(payload)
        buf[pos] = value
        out.append(bytes(buf))
    return out


@pytest.mark.parametrize("name", [n for n, _ in _samples()])
def test_corruptions_raise_the_same_wire_error(name):
    """Truncations, bit flips, duplication, trailing garbage, a bad magic,
    version, kind or dtype code: the port raises the same ``WireError``
    subclass as the reference, on v4 frames and on pre-CRC v2 frames."""
    payload = dict(_samples())[name]
    rng = np.random.default_rng(len(name))
    for frame in (payload, jw._legacy_frame(payload, 2)):
        for bad in _corruptions(frame, rng):
            assert _outcome(tw.decode_payload, bad) == \
                _outcome(jw.decode_payload, bad)
    assert issubclass(tw.WireTruncationError, tw.WireError)
    assert issubclass(tw.WireError, ValueError)


def test_delta_codebook_link_resync_matches_reference():
    """The port's stateful link sends the reference link's bytes on the
    same batches: full codebook, deltas, a forced resync, deltas again."""
    cfg = PQConfig(8, 16, kmeans_iters=3, backend="torch")
    ours_tx, ours_rx = tw.DeltaCodebookLink(), tw.DeltaCodebookLink()
    ref_tx, ref_rx = jw.DeltaCodebookLink(), jw.DeltaCodebookLink()
    st = None
    kinds = []
    for i in range(5):
        qb, st = quantize_stateful(torch.from_numpy(_z(40 + i, 24, 64)),
                                   cfg, st)
        if i == 3:    # the receivers lose lineage: both sides resync
            ours_rx.epoch = ref_rx.epoch = 0
            bad = ours_tx.encode(qb)
            assert bad == ref_tx.encode(_ref_qb(qb))
            with pytest.raises(tw.WireResyncError):
                ours_rx.decode(bad)
            with pytest.raises(jw.WireResyncError):
                ref_rx.decode(bad)
            for link in (ours_tx, ours_rx, ref_tx, ref_rx):
                link.request_resync()
        payload = ours_tx.encode(qb)
        assert payload == ref_tx.encode(_ref_qb(qb))
        kinds.append(tw.payload_kind(payload))
        wb = ours_rx.decode(payload)
        np.testing.assert_array_equal(wb.codebooks, ours_tx.ref)
        np.testing.assert_array_equal(
            wb.codebooks, np.asarray(ref_rx.decode(payload).codebooks))
        assert ours_rx.epoch == ours_tx.epoch == ref_rx.epoch == 1
    assert kinds == ["pq", "pq-delta", "pq-delta", "pq", "pq-delta"]


@pytest.mark.parametrize("geom", [(1152, 2, 1, 20, 9216), (8, 5, 1, 24, 64),
                                  (16, 16, 4, 7, 128)])
def test_wire_bits_equal_reference(geom):
    q, L, r, n, d = geom
    cfg = PQConfig(q, L, num_groups=r)
    jcfg = JPQConfig(q, L, num_groups=r)
    for dtype in DTYPES:
        assert tw.wire_bits(cfg, n, d, dtype) == jw.wire_bits(jcfg, n, d,
                                                              dtype)
    for bits in (4, 8, 16):
        assert tw.pq_delta_wire_bits(cfg, n, d, bits) == \
            jw.pq_delta_wire_bits(jcfg, n, d, bits)
    if d <= 128:   # and the analytic sizes are the encoded lengths
        qb, _ = _port_qb(q, L, r, n, d)
        assert 8 * len(tw.encode_bytes(qb, "bfloat16")) == \
            tw.wire_bits(cfg, n, d, "bfloat16")
        ref = np.zeros(cfg.codebook_shape(d), np.float32)
        assert 8 * len(tw.encode_pq_delta(qb, ref, 4)[0]) == \
            tw.pq_delta_wire_bits(cfg, n, d, 4)
