"""Versioned, tagged wire codec for cut-layer payloads (both directions).

Twin of ``repro/federated/wire.py``: the same frames, byte for byte, from
the port's tensors. What differs from the reference:

  * the inputs are torch tensors (on any device) or numpy arrays; each
    array a frame needs is copied to the host once, as it is encoded;
  * the port's compressors keep a leading client axis on every payload
    array (``core/compressors.py``); ``encode_compressed`` and
    ``encode_bytes`` encode one client's message (``client=``, which a
    batch of several clients must name), the frame the reference encodes
    for that client alone;
  * numpy has no bfloat16 here (no ml_dtypes), so a bf16 value is
    encoded by rounding to ``torch.bfloat16`` (round to nearest even
    from f32, as ml_dtypes rounds) and writing its 16 bits, and decoded
    by placing those bits in the high half of an f32: decoded bf16
    arrays are f32 arrays holding the bf16 values exactly, and
    ``Decoded.dtype`` / ``WireBatch.dtype`` name the wire dtype, so a
    re-encode of a decode stays byte-identical;
  * the codes are packed on the host by ``_pack_codes``, as the reference
    packs them: it takes every width (PQ at L = 5..8 needs 3 bits),
    where the ``pack_codes`` kernel takes b in {1, 2, 4, 8, 16}.

Every payload that crosses the simulated client<->server WAN link is a
24-byte header followed by a kind-specific body:

    +--------+----------------------------------------------------------+
    | header | body (kind-specific, see below)                          |
    | 24 B   |                                                          |
    +--------+----------------------------------------------------------+

  header — magic ``FLW1``, **format version**, value dtype code, bit width,
  **payload kind**, and the geometry tuple (n, d, q, R, L); see ``_HEADER``.
  Version-2 payload kinds:

  * ``pq``     — FedLite's uplink message: (R, L, d/q) codebooks at the wire
                 dtype + all R·(q/R)·N cluster indices packed at
                 b = ceil(log2 L) bits (L=1 needs no codes).
  * ``dense``  — the uncompressed tensor (SplitFed activations, dense
                 downlink gradients): n·d values at the wire dtype.
  * ``sparse`` — top-k sparsification: nnz indices into the flattened
                 tensor packed at ceil(log2 n·d) bits, then either nnz
                 values at the wire dtype or — when the value dtype code is
                 0 — a complete *nested* payload carrying the values (how
                 ``chain:topk+scalarq`` lands on the wire).
  * ``scalar`` — uniform b-bit quantization: an 8-byte f32 (lo, scale)
                 range followed by n·d codes packed at b bits.

  Version-3 adds one kind (older kinds still ride version 2 so v2 decoders
  keep working — the kind is *version-gated*):

  * ``pq-delta`` — the codebook-reuse uplink: instead of L·(d/q)·R fresh
                 fp16 codebook entries, the payload carries uniformly
                 quantized *deltas* against the last acked codebook — an
                 8-byte f32 (lo, scale) range + R·L·(d/q) delta codes at
                 ``delta_bits`` (header ``bits`` field; default 8 → 2× on
                 the codebook component) + the packed cluster codes (width
                 derived from L). The codec is closed-loop (DPCM): the
                 encoder returns the reconstruction ``ref + deq(delta)``
                 and BOTH sides adopt it as the next acked reference, so
                 client and server never drift. Decoding requires the
                 reference (``decode_pq_delta``); the self-describing
                 ``decode_payload`` rejects it with a pointer to that API.

  Version-4 hardens the frame against a hostile wire (the chaos layer,
  ``federated/faults.py``):

  * every v4 frame ends with a 4-byte **CRC32 trailer** over header+body,
    so a bit-flipped, truncated, or duplicated payload is *detected* —
    decoders verify it before touching the body and raise
    `WireCorruptionError` instead of reconstructing garbage;
  * ``pq-delta`` bodies gain a leading u32 **lineage epoch** word: both
    ends of the closed DPCM loop count full-codebook resyncs, and a
    payload whose epoch does not match the receiver's reference raises
    `WireResyncError` — the signal to fall back to a full-codebook
    payload (`DeltaCodebookLink` implements the automatic resync).

Unknown versions and kinds are rejected with a clear error — a stale or
foreign payload fails loudly instead of decoding as garbage. Version-1
payloads (the PR 2 codec, which only ever carried PQ uplink messages with a
zero flags byte where the kind now lives) still decode, as do version-2
and version-3 payloads (no CRC, no epoch word — integrity errors in those
frames are detected only when a length check happens to catch them).
Decode failures raise the typed `WireError` hierarchy (all subclasses of
``ValueError``, so pre-v4 callers catching ``ValueError`` keep working):
`WireTruncationError` (shorter than declared), `WireCorruptionError`
(bad magic / CRC mismatch / inconsistent geometry), `WireVersionError`
(unsupported or version-gated), `WireResyncError` (pq-delta lineage).

The codec is bit-exact: ``decode_payload(encode)`` reproduces every code,
index and range word exactly, values exactly at the wire dtype, and
re-encoding a decoded payload is byte-identical (idempotent; asserted in
tests). The only lossy step is the explicit value dtype cast (and, for
``pq-delta``, the explicit delta quantization — whose reconstruction is
itself bit-exactly reproduced on both sides), which is the transport
decision the paper's φ accounts for — not a codec artifact.

Everything here is host-side numpy — the codec runs on the simulation's
measurement path, never inside the train step. (The b-bit code packing
also has a CUDA twin for on-device producers: ``kernels.scalar_quant``'s
``pack_codes`` writes the identical little-endian LSB-first stream when
32 % b == 0.)
"""

from __future__ import annotations

import struct
import zlib
from typing import Any, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import compressors as comps
from repro_torch.core.quantizer import PQConfig, QuantizedBatch, bits_per_code

# magic, version, dtype code, bit width, payload kind, n, d, q, R, L
_HEADER = struct.Struct("<4sBBBBIIHHI")
HEADER_BYTES = _HEADER.size  # 24
_MAGIC = b"FLW1"
_VERSION = 4          # what every encoder writes (CRC32-trailed frames)
_VERSION_DELTA = 3    # pq-delta is version-gated: introduced in v3
_CRC_VERSION = 4      # frames at version >= 4 end with a CRC32 trailer
_SUPPORTED_VERSIONS = (1, 2, 3, 4)
_CRC = struct.Struct("<I")
CRC_BYTES = _CRC.size  # 4


class WireError(ValueError):
    """Base of the typed decode-failure hierarchy (a ``ValueError`` so
    pre-v4 call sites catching ``ValueError`` keep working)."""


class WireTruncationError(WireError):
    """The payload is shorter than its header/geometry declares."""


class WireCorruptionError(WireError):
    """The payload's content is inconsistent: bad magic, CRC32 mismatch,
    trailing garbage, or geometry that contradicts the body length."""


class WireVersionError(WireError):
    """Unsupported format version, or a kind used below its gate version."""


class WireResyncError(WireError):
    """The pq-delta closed loop lost lineage: the payload's epoch or the
    reference codebook geometry does not match the receiver's state. The
    cure is a full-codebook resync (see `DeltaCodebookLink`)."""

KIND_PQ = 0        # == the version-1 flags byte, so v1 payloads parse as pq
KIND_DENSE = 1
KIND_SPARSE = 2
KIND_SCALAR = 3
KIND_PQ_DELTA = 4  # version >= 3 only
_KIND_NAMES = {KIND_PQ: "pq", KIND_DENSE: "dense", KIND_SPARSE: "sparse",
               KIND_SCALAR: "scalar", KIND_PQ_DELTA: "pq-delta"}

# value dtype code 0 is reserved: in a sparse payload it means "the values
# are carried by a nested payload" (chained compressors)
_DTYPE_CODES = {"float16": 1, "float32": 2, "bfloat16": 3}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}
_NESTED = 0


_ITEMSIZE = {"float16": 2, "float32": 4, "bfloat16": 2}


def _dtype_name(dtype) -> str:
    """The wire name of a str, numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        name = dtype
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = str(dtype)
    if name not in _DTYPE_CODES:
        raise ValueError(f"unsupported wire value dtype {dtype!r}; "
                         f"supported: {sorted(_DTYPE_CODES)}")
    return name


def _host(x) -> np.ndarray:
    """A tensor (any device, any dtype) or array as a host numpy array;
    bf16 tensors become f32 (exact)."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _numel(x) -> int:
    return int(np.prod(tuple(x.shape), dtype=np.int64))


def _wire_values(values, name: str) -> bytes:
    """Values at the wire dtype ``name``, as the frame's bytes. f16 and
    f32 are numpy casts (round to nearest even); bf16 rounds through
    ``torch.bfloat16`` (round to nearest even) and writes its bits, with
    NaNs written as the reference's (ml_dtypes') quiet NaN."""
    if name != "bfloat16":
        return _host(values).astype(name).tobytes()
    t = values.detach() if torch.is_tensor(values) \
        else torch.from_numpy(np.ascontiguousarray(values, np.float32))
    src = t.cpu().contiguous()
    bits = (src if src.dtype == torch.bfloat16 else
            src.float().to(torch.bfloat16)).view(torch.int16).numpy() \
        .view(np.uint16)
    nan = torch.isnan(src).numpy()
    if nan.any():   # the quiet NaN ml_dtypes writes, with the input's sign
        sign = torch.signbit(src).numpy().astype(np.uint16) << np.uint16(15)
        bits = np.where(nan, sign | np.uint16(0x7FC0), bits)
    return bits.tobytes()


def _wire_round(values, name: str) -> np.ndarray:
    """The f32 values a receiver decodes after a trip at ``name``."""
    return _from_wire(_wire_values(values, name), name, _numel(values)) \
        .reshape(tuple(values.shape))


def _from_wire(buf: bytes, name: str, count: int,
               offset: int = 0) -> np.ndarray:
    """``count`` values at wire dtype ``name`` from ``buf``; bf16 comes
    back as f32 (its bits in the high half)."""
    if name != "bfloat16":
        return np.frombuffer(buf, np.dtype(name), count=count, offset=offset)
    bits = np.frombuffer(buf, np.uint16, count=count, offset=offset)
    return (bits.astype(np.uint32) << np.uint32(16)).view(np.float32)


def _check_header(payload: bytes):
    if len(payload) < HEADER_BYTES:
        raise WireTruncationError(
            f"payload shorter than header ({len(payload)} B)")
    fields = _HEADER.unpack_from(payload)
    magic, version, kind = fields[0], fields[1], fields[4]
    if magic != _MAGIC:
        raise WireCorruptionError(f"bad magic {magic!r}")
    if version not in _SUPPORTED_VERSIONS:
        raise WireVersionError(
            f"unsupported wire format version {version}; this codec "
            f"understands versions {_SUPPORTED_VERSIONS} — refusing to "
            f"decode a stale or foreign payload")
    if kind not in _KIND_NAMES:
        raise WireCorruptionError(f"unknown payload kind {kind}; known "
                                  f"kinds: {sorted(_KIND_NAMES.values())}")
    if version == 1 and kind != KIND_PQ:
        raise WireCorruptionError(
            f"version-1 payloads are always pq; got kind {kind}")
    if kind == KIND_PQ_DELTA and version < _VERSION_DELTA:
        raise WireVersionError(
            f"pq-delta payloads require wire version >= {_VERSION_DELTA}; "
            f"got version {version}")
    return fields


def _wire_dtype(code: int) -> str:
    """Map a header dtype code to a wire dtype name, typed-error on
    garbage."""
    name = _CODE_DTYPES.get(code)
    if name is None:
        raise WireCorruptionError(
            f"unknown wire dtype code {code}; known codes: "
            f"{sorted(_CODE_DTYPES)}")
    return name


def _check_pq_geometry(n: int, d: int, q: int, r: int) -> None:
    """Reject header geometry no encoder can produce (decoders divide by
    q and r, so garbage here must fail typed, not crash)."""
    if q == 0 or r == 0 or d % q or q % r or (r * ((q // r) * n)) % max(n, 1):
        raise WireCorruptionError(
            f"inconsistent pq geometry n={n} d={d} q={q} R={r}")


def _seal(frame: bytes) -> bytes:
    """Append the CRC32 trailer every v>=4 frame carries."""
    return frame + _CRC.pack(zlib.crc32(frame) & 0xFFFFFFFF)


def _open_payload(payload: bytes):
    """Header checks + (for v>=4) CRC32 verification.

    Returns ``(fields, frame)`` where ``frame`` is the payload with the
    CRC trailer stripped — the bytes every body length check runs
    against. Pre-v4 frames have no trailer and pass through unchanged.
    """
    fields = _check_header(payload)
    if fields[1] < _CRC_VERSION:
        return fields, payload
    if len(payload) < HEADER_BYTES + CRC_BYTES:
        raise WireTruncationError(
            f"v{fields[1]} payload too short for its CRC32 trailer "
            f"({len(payload)} B)")
    frame, trailer = payload[:-CRC_BYTES], payload[-CRC_BYTES:]
    if (zlib.crc32(frame) & 0xFFFFFFFF) != _CRC.unpack(trailer)[0]:
        raise WireCorruptionError(
            "CRC32 mismatch: the frame was corrupted or truncated in "
            "flight")
    return fields, frame


def payload_kind(payload: bytes) -> str:
    """The kind tag of a payload ("pq" | "dense" | "sparse" | "scalar" |
    "pq-delta") from its header alone — what the byte ledger records
    without decoding the body. Nested chain payloads report the OUTERMOST
    stage, the one the receiver dispatches on first."""
    return _KIND_NAMES[_check_header(payload)[4]]


class WireBatch(NamedTuple):
    """Decoded pq payload: everything the server needs to dequantize."""
    codes: np.ndarray      # (R, (q/R)*n) int32, values in [0, L)
    codebooks: np.ndarray  # (R, L, d/q) at the wire dtype (bf16 as f32)
    n: int                 # activation vectors in the batch
    d: int                 # activation dim
    dtype: str = "float32"  # the codebooks' wire dtype


class Decoded(NamedTuple):
    """One parsed tagged payload (``inner`` set for chained sparse)."""
    kind: str                       # "pq" | "dense" | "sparse" | "scalar"
    n: int
    d: int
    bits: int                       # code/index bit width (kind-specific)
    arrays: dict                    # kind-specific numpy arrays
    inner: Optional["Decoded"] = None
    dtype: Optional[str] = None     # wire dtype of the values/codebooks


# ---------------------------------------------------------------------------
# bit packing
# ---------------------------------------------------------------------------

def _pack_codes(codes: np.ndarray, bits: int) -> bytes:
    """Pack int codes at ``bits`` bits each, LSB-first, into a byte stream."""
    if bits == 0:
        return b""
    flat = codes.reshape(-1).astype(np.uint32)
    bitmat = (flat[:, None] >> np.arange(bits, dtype=np.uint32)) & 1
    return np.packbits(bitmat.astype(np.uint8).reshape(-1),
                       bitorder="little").tobytes()


def _unpack_codes(buf: bytes, count: int, bits: int) -> np.ndarray:
    if bits == 0:
        return np.zeros(count, np.int32)
    flat = np.unpackbits(np.frombuffer(buf, np.uint8),
                         count=count * bits, bitorder="little")
    weights = (np.uint32(1) << np.arange(bits, dtype=np.uint32))
    return (flat.reshape(count, bits).astype(np.uint32) * weights) \
        .sum(axis=1).astype(np.int32)


def _code_stream_bytes(num_codes: int, bits: int) -> int:
    return (num_codes * bits + 7) // 8


# ---------------------------------------------------------------------------
# pq payloads (the PR 2 codec, now kind-tagged)
# ---------------------------------------------------------------------------

def _client_index(clients: int, client: Optional[int]) -> int:
    """Whose message, in a batch of ``clients``: ``client``, or the only
    one; a batch of several clients must name it."""
    if client is None:
        if clients != 1:
            raise ValueError(f"a batch of {clients} clients: pass client=")
        return 0
    return client


def _client_pq(qb: QuantizedBatch, client: Optional[int]):
    """One client's (codes, codebooks, dequantized) from a batch with the
    port's leading client axis, or from a single client's batch (codes
    2-D, as the reference's and ``encode_decoded``'s)."""
    codes, cbs, deq = qb.codes, qb.codebooks, qb.dequantized
    if len(codes.shape) == 3:
        client = _client_index(codes.shape[0], client)
        codes, cbs, deq = codes[client], cbs[client], deq[client]
    return codes, cbs, deq


def encode_bytes(qb: QuantizedBatch,
                 codebook_dtype: Union[str, np.dtype] = "float16", *,
                 client: Optional[int] = None) -> bytes:
    """Serialize a ``QuantizedBatch`` to a ``pq`` payload.

    The geometry (n, d, q, R, L) is derived from the batch itself, so the
    payload is self-describing — ``decode_bytes`` needs no side channel.
    A batch of several clients needs ``client=``, whose message this is.
    """
    codes, cbs, deq = _client_pq(qb, client)
    codes = _host(codes)
    if len(codes.shape) != 2 or len(cbs.shape) != 3 \
            or codes.shape[0] != cbs.shape[0]:
        raise ValueError(f"malformed QuantizedBatch: codes {codes.shape}, "
                         f"codebooks {tuple(cbs.shape)}")
    r, m = codes.shape
    _, num_clusters, dsub = cbs.shape
    d = int(deq.shape[-1])
    n = _numel(deq) // d
    if r * m % max(n, 1) or (r * m // max(n, 1)) * dsub != d:
        raise ValueError(f"code/codebook geometry inconsistent with n={n}, d={d}")
    q = r * m // n

    name = _dtype_name(codebook_dtype)
    bits = bits_per_code(num_clusters)
    if codes.min(initial=0) < 0 or codes.max(initial=0) >= num_clusters:
        raise ValueError("codes out of range [0, L)")
    header = _HEADER.pack(_MAGIC, _VERSION, _DTYPE_CODES[name], bits, KIND_PQ,
                          n, d, q, r, num_clusters)
    return _seal(header + _wire_values(cbs, name)
                 + _pack_codes(codes, bits))


def decode_bytes(payload: bytes) -> WireBatch:
    """Parse a ``pq`` payload back into codes + codebooks, bit-exactly."""
    ((_, _, dtype_code, bits, kind,
      n, d, q, r, num_clusters), frame) = _open_payload(payload)
    if kind != KIND_PQ:
        raise WireCorruptionError(
            f"expected a pq payload, got kind {_KIND_NAMES[kind]!r}; "
            f"use decode_payload for tagged payloads")
    _check_pq_geometry(n, d, q, r)
    dtype = _wire_dtype(dtype_code)
    dsub = d // q
    cb_bytes = r * num_clusters * dsub * _ITEMSIZE[dtype]
    m = (q // r) * n
    code_bytes = _code_stream_bytes(r * m, bits)
    expected = HEADER_BYTES + cb_bytes + code_bytes
    if len(frame) != expected:
        exc = WireTruncationError if len(frame) < expected \
            else WireCorruptionError
        raise exc(f"payload is {len(frame)} B, expected {expected}")
    cbs = _from_wire(frame, dtype, r * num_clusters * dsub,
                     HEADER_BYTES).reshape(r, num_clusters, dsub)
    codes = _unpack_codes(frame[HEADER_BYTES + cb_bytes:], r * m, bits) \
        .reshape(r, m)
    return WireBatch(codes=codes, codebooks=cbs, n=n, d=d, dtype=dtype)


def dequantize(wb: WireBatch) -> np.ndarray:
    """Server-side reconstruction z̃ = codebook gather, (n, d).

    Inverts the grouping of ``quantizer._to_groups``: group r holds
    subvector positions [r·q/R, (r+1)·q/R) of every example.
    """
    r, m = wb.codes.shape
    dsub = wb.codebooks.shape[-1]
    q = r * m // wb.n
    groups = wb.codebooks[np.arange(r)[:, None], wb.codes]  # (R, M, dsub)
    sub = groups.reshape(q, wb.n, dsub).transpose(1, 0, 2)
    return sub.reshape(wb.n, wb.d)


# ---------------------------------------------------------------------------
# pq-delta payloads (cross-round codebook reuse; version >= 3)
# ---------------------------------------------------------------------------

def encode_pq_delta(qb: QuantizedBatch, ref_codebooks: np.ndarray,
                    delta_bits: int = 8, *, epoch: int = 0,
                    client: Optional[int] = None
                    ) -> Tuple[bytes, np.ndarray]:
    """Serialize a ``QuantizedBatch`` as quantized codebook *deltas* against
    the last acked codebook (closed-loop DPCM; see module docstring).

    ``ref_codebooks`` is the (R, L, d/q) f32 reference BOTH sides hold —
    the reconstruction of the previous round's payload, not the client's
    private fp32 codebook. Returns ``(payload, recon)`` where ``recon`` is
    the f32 codebook the decoder will reproduce bit-exactly: the caller
    must adopt it as the next round's reference.

    ``epoch`` is the lineage tag (how many full-codebook resyncs the loop
    has seen); the decoder verifies it against its own count so a delta
    applied to the wrong reference generation raises `WireResyncError`
    instead of silently drifting.

    Codebook bytes: 8 (range) + ceil(R·L·(d/q)·delta_bits / 8), vs
    2·R·L·(d/q) for the fp16 ``pq`` kind — 2× at the default 8 bits.
    """
    if not 0 <= int(epoch) <= 0xFFFFFFFF:
        raise ValueError(f"epoch={epoch} does not fit the u32 lineage word")
    if not 1 <= delta_bits <= 16:
        raise ValueError(f"delta_bits={delta_bits} must be in [1, 16]")
    codes, cbs, deq = _client_pq(qb, client)
    codes = _host(codes)
    cbs = _host(cbs).astype(np.float32)
    ref = np.asarray(_host(ref_codebooks), np.float32)
    if cbs.shape != ref.shape:
        raise ValueError(
            f"reference codebooks {ref.shape} do not match {cbs.shape}")
    r, m = codes.shape
    _, num_clusters, dsub = cbs.shape
    d = int(deq.shape[-1])
    n = _numel(deq) // d
    q = r * m // n

    delta = cbs - ref
    lo = float(delta.min(initial=0.0))
    hi = float(delta.max(initial=0.0))
    levels = (1 << delta_bits) - 1
    scale = (hi - lo) / levels
    scale = np.float32(scale if scale > 0 else 1.0)
    lo = np.float32(lo)
    dcodes = np.clip(np.round((delta - lo) / scale), 0, levels) \
        .astype(np.uint32)
    recon = ref + (lo + dcodes.astype(np.float32) * scale)

    bits = bits_per_code(num_clusters)
    if codes.min(initial=0) < 0 or codes.max(initial=0) >= num_clusters:
        raise ValueError("codes out of range [0, L)")
    header = _HEADER.pack(_MAGIC, _VERSION, _DTYPE_CODES["float32"],
                          delta_bits, KIND_PQ_DELTA, n, d, q, r, num_clusters)
    rng = np.array([lo, scale], np.float32).tobytes()
    return (_seal(header + _CRC.pack(int(epoch)) + rng
                  + _pack_codes(dcodes, delta_bits)
                  + _pack_codes(codes, bits)), recon)


def decode_pq_delta(payload: bytes, ref_codebooks: np.ndarray, *,
                    expected_epoch: Optional[int] = None) -> WireBatch:
    """Parse a ``pq-delta`` payload against the acked reference codebooks.

    The returned ``codebooks`` are f32 and bit-exactly equal to the
    ``recon`` the encoder returned — the server must keep them as the next
    round's reference. ``expected_epoch`` (the receiver's resync count) is
    verified against the payload's lineage word (v4+ frames): a mismatch
    raises `WireResyncError`, as does reference geometry that does not fit
    the payload — both mean the closed loop must resync with a full
    codebook. Version-3 frames carry no epoch word; the check is skipped.
    """
    ((_, version, _, delta_bits, kind,
      n, d, q, r, num_clusters), frame) = _open_payload(payload)
    if kind != KIND_PQ_DELTA:
        raise WireCorruptionError(
            f"expected a pq-delta payload, got kind {_KIND_NAMES[kind]!r}")
    _check_pq_geometry(n, d, q, r)
    ref = np.asarray(_host(ref_codebooks), np.float32)
    dsub = d // q
    if ref.shape != (r, num_clusters, dsub):
        raise WireResyncError(
            f"reference codebooks {ref.shape} do not match the "
            f"payload geometry ({r}, {num_clusters}, {dsub}); the delta "
            f"loop lost lineage — request a full-codebook resync")
    body = frame[HEADER_BYTES:]
    num_delta = r * num_clusters * dsub
    delta_bytes = _code_stream_bytes(num_delta, delta_bits)
    m = (q // r) * n
    bits = bits_per_code(num_clusters)
    epoch_bytes = CRC_BYTES if version >= _CRC_VERSION else 0
    expected = epoch_bytes + 8 + delta_bytes + _code_stream_bytes(r * m, bits)
    if len(body) != expected:
        exc = WireTruncationError if len(body) < expected \
            else WireCorruptionError
        raise exc(f"pq-delta body is {len(body)} B, expected {expected}")
    if epoch_bytes:
        epoch = _CRC.unpack_from(body)[0]
        if expected_epoch is not None and epoch != int(expected_epoch):
            raise WireResyncError(
                f"pq-delta lineage epoch {epoch} does not match the "
                f"receiver's epoch {int(expected_epoch)}; the delta loop "
                f"lost lineage — request a full-codebook resync")
        body = body[epoch_bytes:]
    rng = np.frombuffer(body[:8], np.float32, count=2)
    dcodes = _unpack_codes(body[8:8 + delta_bytes], num_delta, delta_bits) \
        .astype(np.uint32)
    cbs = ref + (rng[0] + dcodes.astype(np.float32) * rng[1]) \
        .reshape(r, num_clusters, dsub)
    codes = _unpack_codes(body[8 + delta_bytes:], r * m, bits).reshape(r, m)
    return WireBatch(codes=codes, codebooks=cbs, n=n, d=d)


def pq_delta_epoch(payload: bytes) -> int:
    """The lineage epoch word of a v4+ ``pq-delta`` payload (header-only
    peek plus CRC verification; no body decode)."""
    (fields, frame) = _open_payload(payload)
    if fields[4] != KIND_PQ_DELTA:
        raise WireCorruptionError(
            f"expected a pq-delta payload, got kind "
            f"{_KIND_NAMES[fields[4]]!r}")
    if fields[1] < _CRC_VERSION:
        raise WireVersionError(
            f"v{fields[1]} pq-delta frames carry no lineage epoch word")
    if len(frame) < HEADER_BYTES + CRC_BYTES:
        raise WireTruncationError("pq-delta frame too short for its epoch")
    return _CRC.unpack_from(frame, HEADER_BYTES)[0]


def pq_delta_wire_bits(cfg: PQConfig, n: int, d: int,
                       delta_bits: int = 8) -> int:
    """Exact ``pq-delta`` payload size in bits (analytic twin of
    ``wire_bits``; asserted against ``len(encode_pq_delta(...))`` in
    tests). Includes the v4 epoch word and CRC32 trailer."""
    r, num_clusters, dsub = cfg.codebook_shape(d)
    cb_bits = 8 * (CRC_BYTES + 8 + _code_stream_bytes(
        r * num_clusters * dsub, delta_bits))
    code_bits = 8 * _code_stream_bytes(cfg.num_codes(n), cfg.bits_per_code)
    return HEADER_BYTES * 8 + cb_bits + code_bits + CRC_BYTES * 8


# ---------------------------------------------------------------------------
# dense / sparse / scalar payloads
# ---------------------------------------------------------------------------

def _legacy_frame(payload: bytes, version: int) -> bytes:
    """Downgrade a current-version payload to an older frame ``version``.

    Test/compat helper: strips the CRC trailer when targeting a pre-CRC
    version, drops the pq-delta epoch word when targeting v3, and rewrites
    the header's version byte. The result is what an encoder of that
    version would have produced for the same content."""
    fields, frame = _open_payload(payload)
    if not 1 <= version <= fields[1]:
        raise ValueError(f"cannot downgrade a v{fields[1]} frame to "
                         f"v{version}")
    body = frame[HEADER_BYTES:]
    if fields[4] == KIND_PQ_DELTA and version < _CRC_VERSION:
        body = body[CRC_BYTES:]   # v3 pq-delta bodies carry no epoch word
    header = _HEADER.pack(_MAGIC, version, *fields[2:])
    out = header + body
    return _seal(out) if version >= _CRC_VERSION else out


class DeltaCodebookLink:
    """One side of the closed-loop pq-delta codebook channel, with lineage.

    Both endpoints hold a ``DeltaCodebookLink``; each starts unsynced
    (``ref is None``, ``epoch == 0``). The sender's ``encode`` ships a full
    ``pq`` codebook payload whenever the link is unsynced (bumping the
    lineage epoch) and b-bit deltas tagged with the current epoch once
    synced. The receiver's ``decode`` verifies the tag against its own
    epoch — a mismatch (or reference-geometry mismatch) raises
    `WireResyncError`, after which the receiver calls ``request_resync()``
    and the runtime signals the sender to do the same. The handshake
    resets BOTH epochs to zero (full pq payloads carry no epoch word, so
    lockstep is re-established by resetting, not by counting), and the
    resync full codebook advances both sides to epoch 1 together."""

    def __init__(self, delta_bits: int = 8,
                 codebook_dtype: Union[str, np.dtype] = "float16", *,
                 client: Optional[int] = None):
        self.delta_bits = int(delta_bits)
        self.codebook_dtype = codebook_dtype
        self.epoch = 0
        self.client = client    # whose message, in a batch of clients
        self.ref: Optional[np.ndarray] = None

    @property
    def synced(self) -> bool:
        return self.ref is not None

    def request_resync(self) -> None:
        """Drop the reference and reset the lineage: the next payload must
        be a full codebook, which re-establishes epoch lockstep."""
        self.ref = None
        self.epoch = 0

    # -- sender side ------------------------------------------------------
    def encode(self, qb: QuantizedBatch) -> bytes:
        if self.ref is None:
            payload = encode_bytes(qb, self.codebook_dtype,
                                   client=self.client)
            # the decoder's reference is the wire-dtype round-trip of the
            # codebooks; adopt the identical f32 values without a decode
            name = _dtype_name(self.codebook_dtype)
            self.ref = _wire_round(_client_pq(qb, self.client)[1], name) \
                .astype(np.float32)
            self.epoch += 1
            return payload
        payload, recon = encode_pq_delta(qb, self.ref, self.delta_bits,
                                         epoch=self.epoch, client=self.client)
        self.ref = recon
        return payload

    # -- receiver side ----------------------------------------------------
    def decode(self, payload: bytes) -> WireBatch:
        if payload_kind(payload) == "pq":
            wb = decode_bytes(payload)
            self.ref = np.asarray(wb.codebooks, np.float32)
            self.epoch += 1
            return wb
        if self.ref is None:
            raise WireResyncError(
                "received a pq-delta payload on an unsynced link; a full "
                "codebook must arrive first")
        wb = decode_pq_delta(payload, self.ref, expected_epoch=self.epoch)
        self.ref = wb.codebooks
        return wb


def encode_dense(values: Any, n: int, d: int,
                 dtype: Union[str, np.dtype, torch.dtype] = "float32"
                 ) -> bytes:
    name = _dtype_name(dtype)
    if not torch.is_tensor(values):
        values = np.asarray(values)
    if _numel(values) != n * d:
        raise ValueError(f"expected {n * d} values, got {_numel(values)}")
    header = _HEADER.pack(_MAGIC, _VERSION, _DTYPE_CODES[name], 0, KIND_DENSE,
                          n, d, 0, 0, 0)
    return _seal(header + _wire_values(values.reshape(n * d), name))


def encode_sparse(indices: np.ndarray, n: int, d: int, *,
                  values: Optional[np.ndarray] = None,
                  inner: Optional[bytes] = None,
                  value_dtype: Union[str, np.dtype] = "float16") -> bytes:
    """Top-k payload: packed flat indices + values (or a nested payload)."""
    if (values is None) == (inner is None):
        raise ValueError("pass exactly one of values / inner")
    idx = _host(indices).reshape(-1).astype(np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= n * d):
        raise ValueError(f"indices out of range [0, {n * d})")
    bits = comps.index_bits(n * d)
    if values is not None:
        name = _dtype_name(value_dtype)
        body = _wire_values(values if torch.is_tensor(values)
                            else np.asarray(values), name)
        dtype_code = _DTYPE_CODES[name]
    else:
        body = inner
        dtype_code = _NESTED
    header = _HEADER.pack(_MAGIC, _VERSION, dtype_code, bits, KIND_SPARSE,
                          n, d, 0, 0, idx.size)
    return _seal(header + _pack_codes(idx.astype(np.uint32), bits) + body)


def encode_scalar(codes: np.ndarray, lo: float, scale: float, bits: int,
                  n: int, d: int) -> bytes:
    """Uniform b-bit payload: 8 B f32 (lo, scale) + packed codes."""
    c = _host(codes).reshape(-1).astype(np.int64)
    if c.size != n * d:
        raise ValueError(f"expected {n * d} codes, got {c.size}")
    if c.size and (c.min() < 0 or c.max() >= (1 << bits)):
        raise ValueError(f"codes out of range [0, 2^{bits})")
    header = _HEADER.pack(_MAGIC, _VERSION, _DTYPE_CODES["float32"], bits,
                          KIND_SCALAR, n, d, 0, 0, 0)
    rng = np.array([lo, scale], np.float32).tobytes()
    return _seal(header + rng + _pack_codes(c.astype(np.uint32), bits))


def decode_payload(payload: bytes) -> Decoded:
    """Parse any tagged payload (recursing into nested sparse values)."""
    ((_, _, dtype_code, bits, kind, n, d, q, r, L),
     frame) = _open_payload(payload)
    body = frame[HEADER_BYTES:]
    if kind == KIND_PQ_DELTA:
        raise WireError(
            "pq-delta payloads are not self-describing: decoding needs the "
            "acked reference codebooks — use decode_pq_delta(payload, ref)")
    if kind == KIND_PQ:
        wb = decode_bytes(payload)
        return Decoded("pq", n, d, bits,
                       {"codes": wb.codes, "codebooks": wb.codebooks},
                       dtype=wb.dtype)
    if kind == KIND_DENSE:
        dtype = _wire_dtype(dtype_code)
        expected = n * d * _ITEMSIZE[dtype]
        if len(body) != expected:
            exc = WireTruncationError if len(body) < expected \
                else WireCorruptionError
            raise exc(f"dense body is {len(body)} B, expected {expected}")
        vals = _from_wire(frame, dtype, n * d, HEADER_BYTES).reshape(n, d)
        return Decoded("dense", n, d, 0, {"values": vals}, dtype=dtype)
    if kind == KIND_SPARSE:
        nnz = L
        idx_bytes = _code_stream_bytes(nnz, bits)
        if len(body) < idx_bytes:
            raise WireTruncationError(
                f"sparse indices are {len(body)} B, expected {idx_bytes}")
        idx = _unpack_codes(body[:idx_bytes], nnz, bits)
        rest = body[idx_bytes:]
        if dtype_code == _NESTED:
            inner = decode_payload(rest)
            return Decoded("sparse", n, d, bits, {"indices": idx},
                           inner=inner)
        dtype = _wire_dtype(dtype_code)
        size = _ITEMSIZE[dtype]
        if len(rest) != nnz * size:
            exc = WireTruncationError if len(rest) < nnz * size \
                else WireCorruptionError
            raise exc(f"sparse values are {len(rest)} B, expected "
                      f"{nnz * size}")
        vals = _from_wire(rest, dtype, nnz)
        return Decoded("sparse", n, d, bits,
                       {"indices": idx, "values": vals}, dtype=dtype)
    if kind == KIND_SCALAR:
        expected = 8 + _code_stream_bytes(n * d, bits)
        if len(body) != expected:
            exc = WireTruncationError if len(body) < expected \
                else WireCorruptionError
            raise exc(f"scalar body is {len(body)} B, expected {expected}")
        rng = np.frombuffer(body[:8], np.float32, count=2)
        codes = _unpack_codes(body[8:], n * d, bits)
        return Decoded("scalar", n, d, bits,
                       {"codes": codes, "lo": rng[0], "scale": rng[1]})
    # _check_header already rejects unknown kinds; this guards the dispatch
    # above staying exhaustive when the next kind is added
    raise WireError(f"no decoder arm for payload kind "
                    f"{_KIND_NAMES.get(kind, kind)!r}")


def reconstruct(dp: Decoded) -> np.ndarray:
    """Receiver-side reconstruction of a decoded payload, (n, d)."""
    if dp.kind == "pq":
        wb = WireBatch(codes=dp.arrays["codes"],
                       codebooks=dp.arrays["codebooks"], n=dp.n, d=dp.d)
        return dequantize(wb)
    if dp.kind == "dense":
        return np.asarray(dp.arrays["values"], np.float32)
    if dp.kind == "scalar":
        return (dp.arrays["lo"]
                + dp.arrays["codes"].astype(np.float32) * dp.arrays["scale"]
                ).reshape(dp.n, dp.d)
    # sparse
    vals = reconstruct(dp.inner).reshape(-1) if dp.inner is not None \
        else np.asarray(dp.arrays["values"], np.float32)
    flat = np.zeros(dp.n * dp.d, np.float32)
    flat[dp.arrays["indices"]] = vals
    return flat.reshape(dp.n, dp.d)


def encode_decoded(dp: Decoded,
                   value_dtype: Union[str, np.dtype] = "float16") -> bytes:
    """Re-serialize a decoded payload (round-trip idempotence helper).

    ``value_dtype`` applies only where the decoded arrays do not already
    carry a wire dtype (they always do after ``decode_payload``, so a
    re-encode of a decode is byte-identical)."""
    if dp.kind == "pq":
        qb = QuantizedBatch(
            dequantized=reconstruct(dp), codes=dp.arrays["codes"],
            codebooks=dp.arrays["codebooks"],
            distortion=np.zeros(()), residual=np.zeros(()))
        return encode_bytes(qb, dp.dtype)
    if dp.kind == "dense":
        return encode_dense(dp.arrays["values"], dp.n, dp.d, dp.dtype)
    if dp.kind == "scalar":
        return encode_scalar(dp.arrays["codes"], dp.arrays["lo"],
                             dp.arrays["scale"], dp.bits, dp.n, dp.d)
    if dp.inner is not None:
        return encode_sparse(dp.arrays["indices"], dp.n, dp.d,
                             inner=encode_decoded(dp.inner, value_dtype))
    return encode_sparse(dp.arrays["indices"], dp.n, dp.d,
                         values=dp.arrays["values"], value_dtype=dp.dtype)


# ---------------------------------------------------------------------------
# compressor -> wire bytes (the `CutCompressor.wire_payload` backend)
# ---------------------------------------------------------------------------

def _geometry(recon):
    d = int(recon.shape[-1])
    return _numel(recon) // d, d


def _client_payload(payload, client: int):
    """One client's slice of a stage payload (every array of the port's
    payloads has the leading client axis)."""
    return type(payload)(*(x[client] for x in payload))


def encode_compressed(compressor: "comps.CutCompressor",
                      comp: comps.Compressed,
                      value_dtype: Union[str, np.dtype] = "float16", *,
                      client: Optional[int] = None) -> bytes:
    """Serialize one client's part of a `Compressed` result (the port's
    compressors work on a leading client axis) to its tagged wire
    payload: the frame the reference writes for that client's tensor.
    A result of several clients needs ``client=``, whose message this is.

    Dense payloads keep the tensor's native dtype (lossless — they ARE the
    uncompressed baseline); sparse/pq values ride at ``value_dtype``.
    """
    client = _client_index(comp.recon.shape[0], client)
    n, d = _geometry(comp.recon[client])
    if isinstance(compressor, comps.ChainCompressor):
        payloads = [_client_payload(p, client) for p in comp.payload]
        executed = compressor.stages[:len(payloads)]
        # each stage's payload is encoded against the stage's OWN input
        # geometry: the full tensor for stage 0, the previous stage's
        # carrier (a flat (k, 1) vector) for every later stage
        geoms = []
        cur = (n, d)
        for payload in payloads:
            geoms.append(cur)
            if isinstance(payload, comps.SparsePayload):
                cur = (_numel(payload.values), 1)
            # dense (identity) stages pass their input through unchanged;
            # terminal payloads (pq/scalar) end the walk with the loop
        inner: Optional[bytes] = None
        for stage, payload, (sn, sd) in zip(reversed(executed),
                                            reversed(payloads),
                                            reversed(geoms)):
            inner = _encode_stage(stage, payload, sn, sd, inner, value_dtype)
        return inner
    return _encode_stage(compressor, _client_payload(comp.payload, client),
                         n, d, None, value_dtype)


def _encode_stage(stage, payload, n, d, inner, value_dtype) -> bytes:
    if isinstance(payload, comps.DensePayload):
        if inner is not None:
            return inner   # the identity stage adds nothing to the wire
        vals = payload.values
        return encode_dense(vals, n, d, vals.dtype)
    if isinstance(payload, QuantizedBatch):
        if inner is not None:
            raise ValueError("pq payloads are terminal; nothing may nest")
        return encode_bytes(payload, value_dtype)
    if isinstance(payload, comps.SparsePayload):
        if inner is not None:
            return encode_sparse(payload.indices, n, d, inner=inner)
        return encode_sparse(payload.indices, n, d, values=payload.values,
                             value_dtype=value_dtype)
    if isinstance(payload, comps.ScalarPayload):
        if inner is not None:
            raise ValueError("scalar payloads are terminal; nothing may nest")
        # geometry comes from the stage's OWN input (the chain carrier when
        # nested, the full tensor when standalone), i.e. the codes shape
        codes = _host(payload.codes)
        sd = codes.shape[-1] if codes.ndim >= 2 else 1
        return encode_scalar(codes, float(_host(payload.lo)),
                             float(_host(payload.scale)),
                             stage.bits, codes.size // sd, sd)
    raise TypeError(f"no wire encoding for payload type {type(payload)!r}")


# ---------------------------------------------------------------------------
# analytic size accounting (must match len(encode_...) exactly)
# ---------------------------------------------------------------------------

def wire_bits(cfg: PQConfig, n: int, d: int,
              codebook_dtype: Union[str, np.dtype] = "float16") -> int:
    """Exact pq payload size in bits for an (n, d) batch under ``cfg``.

    ``tests/test_wire.py`` asserts this equals ``8 * len(encode_bytes(...))``
    and stays within ``HEADER_BYTES*8 + 7`` bits of
    ``cfg.message_bits(n, d, phi_bits=<wire width>)``.
    """
    w = _ITEMSIZE[_dtype_name(codebook_dtype)] * 8
    r, num_clusters, dsub = cfg.codebook_shape(d)
    cb_bits = r * num_clusters * dsub * w
    code_bits = 8 * _code_stream_bytes(cfg.num_codes(n), cfg.bits_per_code)
    return HEADER_BYTES * 8 + cb_bits + code_bits + CRC_BYTES * 8


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------
# Spans around the public codec entry points, applied by reassignment, as
# in the reference (whose encode_* bodies are pinned by AST hash); internal
# callers resolve the module globals at call time, so nested stages record
# nested spans. All wrappers are no-ops until `obs.configure` runs.
from repro_torch import obs as _obs  # noqa: E402

encode_bytes = _obs.instrument("wire.encode_bytes", cat="wire")(encode_bytes)
decode_bytes = _obs.instrument("wire.decode_bytes", cat="wire")(decode_bytes)
encode_pq_delta = _obs.instrument("wire.encode_pq_delta",
                                  cat="wire")(encode_pq_delta)
decode_pq_delta = _obs.instrument("wire.decode_pq_delta",
                                  cat="wire")(decode_pq_delta)
encode_compressed = _obs.instrument("wire.encode_compressed",
                                    cat="wire")(encode_compressed)
decode_payload = _obs.instrument("wire.decode_payload",
                                 cat="wire")(decode_payload)
