"""Direction-agnostic cut-layer compressors (twin of
``repro/core/compressors.py``).

A ``CutCompressor`` is one codec for the cut layer, in either direction:

  * ``none``    -- identity (dense payload; the SplitFed baseline).
  * ``pq``      -- FedLite's grouped product quantizer (``core/quantizer``).
  * ``topk``    -- keep the largest-|z| fraction ``k`` of the entries.
  * ``scalarq`` -- uniform ``bits``-bit scalar quantization over the
                   tensor's [min, max] range; nearest rounding (the
                   ``scalar_quantize`` CUDA kernel on ``"cuda"``/``"auto"``
                   for CUDA tensors), or stochastic rounding when a
                   ``torch.Generator`` is passed.
  * ``chain``   -- each stage compresses the dense value carrier of the
                   previous stage, e.g. ``chain:topk(k=0.1)+scalarq(bits=8)``.

Clients: every tensor has a leading client axis C, and each client is
compressed on its own, as the reference's per-client ``vmap`` does: a
top-k keeps k of each client's entries, a scalarq range is each client's
[min, max], and payload arrays carry the client axis too.

Every compressor answers: ``compress(z) -> Compressed`` (recon, residual,
payload) and ``analytic_bits(n, d, phi)`` (per client, composed from
``overhead_bits`` and ``carrier_elems`` so that chains add up exactly).
``wire_payload(comp, client=c)`` serializes client c's message with the
tagged wire codec (``federated/wire.py``), byte for byte the reference's.

Direction hooks, each a ``torch.autograd.Function``:

  * ``compress_with_correction(_stats)`` -- the uplink: forward emits the
    reconstruction, backward adds FedLite's λ·(z − z̃) (eq. 5) from the
    residual the forward compress produced.
  * ``compress_with_correction_carry`` -- the same, threading a
    ``CutState`` (PQ codebook warm start and error-feedback memory) through
    the round and returning the next one.
  * ``compress_downlink(_keyed|_stateful)`` -- the downlink: identity
    forward; the backward pass sends the activation cotangent through the
    compressor before it reaches the client. ``none`` returns the cotangent
    itself, bitwise. Where the reference returns a float0 or zero cotangent
    for λ, a key or a state, these return ``None``.

Spec strings are parsed by ``make_compressor``: ``"none"``, ``"pq"``,
``"topk(k=0.1)"``, ``"scalarq(bits=8)"``,
``"chain:topk(k=0.1)+scalarq(bits=8)"``.
"""

from __future__ import annotations

import ast
import dataclasses
import math
import re
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import kmeans as _km
from repro_torch.core.quantizer import (PQConfig, QuantizerState, quantize,
                                        quantize_stateful)
from repro_torch.kernels import ops, ref

Generator = Optional[torch.Generator]


# ---------------------------------------------------------------------------
# payloads
# ---------------------------------------------------------------------------

class DensePayload(NamedTuple):
    values: torch.Tensor       # the tensor itself (identity compressor)


class SparsePayload(NamedTuple):
    indices: torch.Tensor      # (C, k) int32 into each client's flat tensor
    values: torch.Tensor       # (C, k) surviving values (the carrier)


class ScalarPayload(NamedTuple):
    codes: torch.Tensor        # int32, input shape, values in [0, 2^bits)
    lo: torch.Tensor           # (C,) f32 dequantization offset
    scale: torch.Tensor        # (C,) f32 dequantization step


class Compressed(NamedTuple):
    """One compress: what the other side reconstructs, the residual the
    corrected backward pass consumes, and the pieces a wire would carry."""
    recon: torch.Tensor        # decompressed tensor, input shape + dtype
    residual: torch.Tensor     # z − recon, input shape + dtype
    payload: Any               # DensePayload | QuantizedBatch | SparsePayload
    #                            | ScalarPayload | tuple of stage payloads


class CutState(NamedTuple):
    """Cross-round carry for one cut-layer direction; ``None`` switches a
    mechanism off.

      * ``quantizer`` -- ``core/quantizer.QuantizerState``: the previous
        round's per-client PQ codebooks (warm-started Lloyd).
      * ``ef_memory`` -- error-feedback memory, the cut tensor's shape: the
        accumulated compression error, re-added to the next round's input.

    Passing a ``CutState`` (even one with both fields ``None``) to the
    carrying hook asks for a new state back: the bootstrap round."""
    quantizer: Any = None
    ef_memory: Any = None


def index_bits(num_slots: int) -> int:
    """Packed index width for a flattened tensor of ``num_slots`` entries."""
    return max(math.ceil(math.log2(max(num_slots, 2))), 1)


# ---------------------------------------------------------------------------
# the compressor protocol
# ---------------------------------------------------------------------------

class CutCompressor:
    """Base class: a direction-agnostic cut-layer codec (frozen dataclasses
    below, so a compressor is hashable and compares by value)."""
    name: str = "base"

    @property
    def spec(self) -> str:
        """Round-trippable spec string, parameters included."""
        return self.name

    def compress(self, z: torch.Tensor, *,
                 generator: Generator = None) -> Compressed:
        raise NotImplementedError

    def compress_stateful(self, z: torch.Tensor, state: Any = None, *,
                          generator: Generator = None
                          ) -> Tuple[Compressed, Any]:
        """(Compressed, next round's codec state). Stateless here; the PQ
        compressor warm-starts from its ``QuantizerState``."""
        del state
        return self.compress(z, generator=generator), None

    def decompress(self, comp: Compressed) -> torch.Tensor:
        return comp.recon

    def carrier(self, comp: Compressed) -> Optional[torch.Tensor]:
        """The dense values a later chain stage may compress further (None:
        the payload is terminal)."""
        return None

    def recompose(self, comp: Compressed, carrier_recon: torch.Tensor,
                  z: torch.Tensor) -> Compressed:
        """Rebuild ``comp`` after a later stage reconstructed its carrier
        lossily; ``z`` is this stage's input (for the residual)."""
        raise NotImplementedError(f"{self.name} has no carrier to recompose")

    # ---- analytic accounting, per client ---------------------------------
    def overhead_bits(self, n: int, d: int, phi_bits: int) -> int:
        """Bits of structure this stage transmits (indices, scales, ...)."""
        raise NotImplementedError

    def carrier_elems(self, n: int, d: int) -> int:
        """Dense values this stage leaves for the next one."""
        raise NotImplementedError

    def analytic_bits(self, n: int, d: int, phi_bits: int = 32) -> int:
        """Message bits for an (n, d) batch when this stage is terminal."""
        return self.overhead_bits(n, d, phi_bits) \
            + self.carrier_elems(n, d) * phi_bits

    # ---- wire -------------------------------------------------------------
    def wire_payload(self, comp: Compressed, value_dtype: str = "float16",
                     *, client: Optional[int] = None) -> bytes:
        """Serialize one client's message to the tagged wire format
        (``federated/wire.py``): the frame the reference writes for that
        client's tensor. A result of several clients needs ``client=``."""
        from repro_torch.federated import wire  # federated imports core
        return wire.encode_compressed(self, comp, value_dtype=value_dtype,
                                      client=client)


# ---------------------------------------------------------------------------
# implementations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NoneCompressor(CutCompressor):
    """Identity: dense payload; ``compress_downlink`` is a bitwise no-op."""
    name: str = dataclasses.field(default="none", init=False)

    def compress(self, z, *, generator=None) -> Compressed:
        return Compressed(recon=z, residual=torch.zeros_like(z),
                          payload=DensePayload(values=z))

    def carrier(self, comp):
        return comp.payload.values

    def recompose(self, comp, carrier_recon, z):
        recon = carrier_recon.reshape(z.shape).to(z.dtype)
        return Compressed(recon=recon, residual=z - recon,
                          payload=DensePayload(values=recon))

    def overhead_bits(self, n, d, phi_bits):
        return 0

    def carrier_elems(self, n, d):
        return n * d


@dataclasses.dataclass(frozen=True)
class PQCompressor(CutCompressor):
    """FedLite's grouped PQ (§4.1) behind the protocol: ``core/quantizer``'s
    ``quantize`` on (C, n, d), whose ``QuantizedBatch`` is the payload."""
    cfg: PQConfig
    name: str = dataclasses.field(default="pq", init=False)

    @property
    def spec(self) -> str:
        return (f"pq(q={self.cfg.num_subvectors},L={self.cfg.num_clusters},"
                f"R={self.cfg.num_groups})")

    @staticmethod
    def _clients(z):
        return z.reshape(z.shape[0], -1, z.shape[-1])

    def compress(self, z, *, generator=None) -> Compressed:
        qb = quantize(self._clients(z), self.cfg, generator)
        return Compressed(recon=qb.dequantized.reshape(z.shape),
                          residual=qb.residual.reshape(z.shape), payload=qb)

    def compress_stateful(self, z, state: Optional[QuantizerState] = None, *,
                          generator=None
                          ) -> Tuple[Compressed, QuantizerState]:
        """A prior ``QuantizerState`` resumes Lloyd from last round's
        codebooks at ``cfg.effective_warm_iters`` iterations; ``None`` runs
        the cold round and bootstraps the state."""
        qb, new_state = quantize_stateful(self._clients(z), self.cfg, state,
                                          generator)
        return Compressed(recon=qb.dequantized.reshape(z.shape),
                          residual=qb.residual.reshape(z.shape),
                          payload=qb), new_state

    def overhead_bits(self, n, d, phi_bits):
        return self.cfg.message_bits(n, d, phi_bits=phi_bits)

    def carrier_elems(self, n, d):
        return 0


@dataclasses.dataclass(frozen=True)
class TopKCompressor(CutCompressor):
    """Keep each client's largest-|z| fraction ``k`` of entries.

    The payload is (indices, values) over each client's flattened tensor,
    indices in increasing order; the values are the carrier a chained stage
    compresses further. Among equal magnitudes the lower index is kept, as
    ``jax.lax.top_k`` does."""
    k: float = 0.1
    name: str = dataclasses.field(default="topk", init=False)

    @property
    def spec(self) -> str:
        return f"topk(k={self.k})"

    def __post_init__(self):
        if not 0.0 < self.k <= 1.0:
            raise ValueError(f"topk fraction k={self.k} must be in (0, 1]")

    def k_count(self, num_elems: int) -> int:
        return max(int(round(self.k * num_elems)), 1)

    def compress(self, z, *, generator=None) -> Compressed:
        flat = z.reshape(z.shape[0], -1)
        kc = self.k_count(flat.shape[1])
        # a stable descending sort keeps the lower index among ties
        order = torch.sort(flat.float().abs(), dim=-1, descending=True,
                           stable=True).indices[:, :kc]
        idx = order.sort(dim=-1).values      # canonical order for the wire
        vals = flat.gather(1, idx)
        recon = torch.zeros_like(flat).scatter(1, idx, vals).reshape(z.shape)
        return Compressed(recon=recon, residual=z - recon,
                          payload=SparsePayload(indices=idx.to(torch.int32),
                                                values=vals))

    def carrier(self, comp):
        return comp.payload.values

    def recompose(self, comp, carrier_recon, z):
        flat = torch.zeros((z.shape[0], z[0].numel()), dtype=z.dtype,
                           device=z.device)
        flat = flat.scatter(1, comp.payload.indices.long(),
                            carrier_recon.to(z.dtype))
        recon = flat.reshape(z.shape)
        return Compressed(recon=recon, residual=z - recon,
                          payload=SparsePayload(indices=comp.payload.indices,
                                                values=carrier_recon))

    def overhead_bits(self, n, d, phi_bits):
        return self.k_count(n * d) * index_bits(n * d)

    def carrier_elems(self, n, d):
        return self.k_count(n * d)


@dataclasses.dataclass(frozen=True)
class ScalarQuantCompressor(CutCompressor):
    """Uniform b-bit scalar quantization over each client's [min, max].

    ``codes = round((z − lo)/scale)`` with ``scale = (hi − lo)/(2^b − 1)``
    (1 where hi == lo), half to even; ``recon = lo + codes·scale``. With a
    generator the rounding is stochastic (``floor(t + U[0, 1))``, unbiased)
    and runs in plain PyTorch, as the reference's keyed path runs jnp.
    Without one, the backend decides: ``"cuda"`` (and ``"auto"`` on a CUDA
    tensor) launches the ``scalar_quantize`` kernel for all clients at
    once, ``"torch"`` runs its plain version."""
    bits: int = 8
    backend: str = "auto"
    name: str = dataclasses.field(default="scalarq", init=False)

    @property
    def spec(self) -> str:
        return f"scalarq(bits={self.bits})"

    def __post_init__(self):
        if not 1 <= self.bits <= 16:
            raise ValueError(f"scalarq bits={self.bits} must be in [1, 16]")
        if self.backend not in _km.available_backends():
            raise ValueError(f"backend={self.backend!r} not one of "
                             f"{_km.available_backends()}")

    def compress(self, z, *, generator=None) -> Compressed:
        flat = z.reshape(z.shape[0], -1)
        # the min and max of z's own values, exact in f32 (bf16 -> f32 is
        # exact): no f32 copy of z on the kernel path
        lo = flat.amin(-1).float()
        hi = flat.amax(-1).float()
        levels = (1 << self.bits) - 1
        scale = (hi - lo) / levels
        scale = torch.where(scale > 0, scale, 1.0)
        if generator is not None:   # stochastic: E[codes·scale] = z − lo
            t = (flat.float() - lo[:, None]) / scale[:, None]
            t = torch.floor(t + torch.rand(t.shape, generator=generator,
                                           device=t.device))
            q = t.clamp(0.0, float(levels))
            codes, recon = q.to(torch.int32), lo[:, None] + q * scale[:, None]
        elif _km.resolve_backend(self.backend, z.device) == "cuda":
            _km._require_cuda(z)
            codes, recon = ops.scalar_quantize(flat, lo, scale, self.bits)
        else:
            codes, recon = ref.scalar_quantize_ref(flat, lo, scale,
                                                   self.bits)
        recon = recon.reshape(z.shape).to(z.dtype)
        return Compressed(recon=recon, residual=z - recon,
                          payload=ScalarPayload(codes=codes.reshape(z.shape),
                                                lo=lo, scale=scale))

    def overhead_bits(self, n, d, phi_bits):
        return 2 * 32 + n * d * self.bits   # lo + scale at f32, packed codes

    def carrier_elems(self, n, d):
        return 0


@dataclasses.dataclass(frozen=True)
class ChainCompressor(CutCompressor):
    """Sequential composition: stage i+1 compresses stage i's carrier.

    Only the first stage sees the (C, n, d) tensor; later stages see the
    (C, k) values the previous payload carries. A stage without a carrier
    (pq, scalarq) ends the chain. A generator is handed to every stage."""
    stages: Tuple[CutCompressor, ...]
    name: str = dataclasses.field(default="chain", init=False)

    def __post_init__(self):
        if len(self.stages) < 2:
            raise ValueError("chain needs at least two stages")
        for s in self.stages[:-1]:
            if s.carrier_elems(1, 1) == 0 and \
                    not isinstance(s, NoneCompressor):
                raise ValueError(
                    f"chain stage {s.name!r} is terminal (no carrier); "
                    f"only the last stage may be")

    @property
    def spec(self) -> str:
        return "chain:" + "+".join(s.spec for s in self.stages)

    def compress(self, z, *, generator=None) -> Compressed:
        comps, inputs = [], []
        x = z
        for stage in self.stages:
            inputs.append(x)
            comp = stage.compress(x, generator=generator)
            comps.append(comp)
            x = stage.carrier(comp)
            if x is None:
                break
        # fold the last stage's lossy reconstruction back up the chain
        recon = comps[-1].recon
        executed = self.stages[:len(comps)]
        for stage, comp, x_in in zip(reversed(executed[:-1]),
                                     reversed(comps[:-1]),
                                     reversed(inputs[:-1])):
            recon = stage.recompose(comp, recon, x_in).recon
        return Compressed(recon=recon, residual=z - recon,
                          payload=tuple(c.payload for c in comps))

    def overhead_bits(self, n, d, phi_bits):
        total, nn, dd = 0, n, d
        for stage in self.stages:
            total += stage.overhead_bits(nn, dd, phi_bits)
            elems = stage.carrier_elems(nn, dd)
            if elems == 0:
                break
            nn, dd = elems, 1   # downstream stages see a flat carrier
        return total

    def carrier_elems(self, n, d):
        nn, dd = n, d
        for stage in self.stages:
            elems = stage.carrier_elems(nn, dd)
            if elems == 0:
                return 0
            nn, dd = elems, 1
        return nn * dd


# ---------------------------------------------------------------------------
# error feedback (the memory is the caller's state)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ErrorFeedback:
    """Error feedback (Seide et al. 2014; Karimireddy et al. 2019): the
    compression error is remembered and re-added to the next input,

        comp = c.compress(z + mem);   mem' = (z + mem) − comp.recon

    so a contractive compressor sends the whole signal eventually."""
    compressor: CutCompressor

    def init_memory(self, z: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(z)

    def step(self, z: torch.Tensor, memory: torch.Tensor, *,
             generator: Generator = None
             ) -> Tuple[Compressed, torch.Tensor]:
        corrected = z + memory
        comp = self.compressor.compress(corrected, generator=generator)
        return comp, corrected - comp.recon


# ---------------------------------------------------------------------------
# registry + spec parsing
# ---------------------------------------------------------------------------

_FACTORIES: Dict[str, Callable[..., CutCompressor]] = {}


def register_compressor(name: str,
                        factory: Callable[..., CutCompressor]) -> None:
    """Register (or replace) a named compressor factory."""
    _FACTORIES[name] = factory


register_compressor("none", lambda **kw: NoneCompressor(**kw))
register_compressor("pq", lambda **kw: PQCompressor(**kw))
register_compressor("topk", lambda **kw: TopKCompressor(**kw))
register_compressor("scalarq", lambda **kw: ScalarQuantCompressor(**kw))


def available_compressors() -> Tuple[str, ...]:
    return tuple(sorted(_FACTORIES)) + ("chain",)


_CALL_RE = re.compile(r"^(?P<name>[a-zA-Z_][\w]*)(?:\((?P<args>.*)\))?$")


def _parse_one(spec: str, pq: Optional[PQConfig]) -> CutCompressor:
    m = _CALL_RE.match(spec.strip())
    if not m:
        raise ValueError(f"malformed compressor spec {spec!r}")
    name, args = m.group("name"), m.group("args")
    if name not in _FACTORIES:
        raise ValueError(f"unknown compressor {name!r}; registered: "
                         f"{available_compressors()}")
    kwargs: Dict[str, Any] = {}
    for part in (args or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"compressor arg {part!r} must be key=value")
        k, v = part.split("=", 1)
        try:
            kwargs[k.strip()] = ast.literal_eval(v.strip())
        except (ValueError, SyntaxError):
            kwargs[k.strip()] = v.strip()   # bare strings, e.g. backend=torch
    if name == "pq" and "cfg" not in kwargs:
        if pq is None:
            raise ValueError(
                "spec 'pq' needs a PQConfig: pass make_compressor(..., pq=...)")
        kwargs["cfg"] = pq
    return _FACTORIES[name](**kwargs)


def make_compressor(spec, *, pq: Optional[PQConfig] = None
                    ) -> Optional[CutCompressor]:
    """A compressor from a spec string (see the module docstring). A built
    ``CutCompressor`` comes back as it is, ``None`` as ``None`` (direction
    not configured); ``pq`` is the PQConfig a bare ``"pq"`` wraps."""
    if spec is None or isinstance(spec, CutCompressor):
        return spec
    spec = spec.strip()
    if spec.startswith("chain:"):
        return ChainCompressor(stages=tuple(
            _parse_one(s, pq) for s in spec[len("chain:"):].split("+")))
    return _parse_one(spec, pq)


# ---------------------------------------------------------------------------
# direction hooks
# ---------------------------------------------------------------------------

def _lam_tensor(lam, device) -> torch.Tensor:
    return lam.detach().float() if torch.is_tensor(lam) else \
        torch.full((), lam, dtype=torch.float32, device=device)


def _distortion(residual: torch.Tensor) -> torch.Tensor:
    """Mean ‖residual‖² per vector (the trailing axis), per client: (C,)."""
    r = residual.float().reshape(residual.shape[0], -1)
    n = max(residual[0].numel() // residual.shape[-1], 1)
    return r.square().sum(-1) / n


class _CompressWithCorrection(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, lam, compressor):
        comp = compressor.compress(z)
        ctx.save_for_backward(comp.residual, _lam_tensor(lam, z.device))
        dist = _distortion(comp.residual)
        ctx.mark_non_differentiable(dist)
        return comp.recon, dist

    @staticmethod
    def backward(ctx, g, _g_distortion):
        # eq. (5); the distortion is a metric: its cotangent is dropped
        residual, lam = ctx.saved_tensors
        return g + lam.to(g.dtype) * residual.to(g.dtype), None, None


def compress_with_correction(z: torch.Tensor, lam,
                             compressor: CutCompressor) -> torch.Tensor:
    """Uplink hook: the compressed reconstruction, with the eq.-5 backward
    ``g + λ·(z − z̃)`` from the forward compress's residual."""
    return _CompressWithCorrection.apply(z, lam, compressor)[0]


def compress_with_correction_stats(z: torch.Tensor, lam,
                                   compressor: CutCompressor):
    """Like ``compress_with_correction``, and also the per-client mean
    ‖z − z̃‖² per vector (C,), a non-differentiable metric."""
    return _CompressWithCorrection.apply(z, lam, compressor)


class _CompressCarry(torch.autograd.Function):
    """Outputs (recon, distortion, *new state leaves): a Function returns
    tensors only, so the new ``CutState`` goes out flat, new EF memory
    first (iff the input state had one), then the quantizer's codebooks
    and rounds (iff the compressor keeps state)."""

    @staticmethod
    def forward(ctx, z, lam, state, compressor):
        z_in = z if state.ef_memory is None \
            else z + state.ef_memory.to(z.dtype)
        comp, new_q = compressor.compress_stateful(z_in, state.quantizer)
        leaves = [] if state.ef_memory is None else [comp.residual.clone()]
        if new_q is not None:
            leaves.extend(new_q)
        dist = _distortion(comp.residual)
        ctx.save_for_backward(comp.residual, _lam_tensor(lam, z.device))
        ctx.mark_non_differentiable(dist, *leaves)
        return (comp.recon, dist, *leaves)

    @staticmethod
    def backward(ctx, g, *_metric_and_state):
        residual, lam = ctx.saved_tensors
        return g + lam.to(g.dtype) * residual.to(g.dtype), None, None, None


def compress_with_correction_carry(z: torch.Tensor, lam, state: CutState,
                                   compressor: CutCompressor):
    """State-carrying uplink hook: ``(recon, distortion (C,), new_state)``.

    Forward: with ``state.ef_memory``, error feedback compresses
    ``z_in = z + memory`` and the new memory is ``z_in − recon``; the
    compress resumes from ``state.quantizer`` (PQ warm start; stateless
    codecs ignore it and return ``None``). Backward: eq. 5,
    ``g + λ·(z_in − recon)``; λ and the state get no gradient."""
    recon, dist, *leaves = _CompressCarry.apply(z, lam, state, compressor)
    ef = leaves.pop(0) if state.ef_memory is not None else None
    quantizer = QuantizerState(*leaves) if leaves else None
    return recon, dist, CutState(quantizer=quantizer, ef_memory=ef)


class _CompressDownlink(torch.autograd.Function):

    @staticmethod
    def forward(ctx, z, compressor, generator, state):
        ctx.codec = (compressor, generator, state)
        return z.view_as(z)

    @staticmethod
    def backward(ctx, g):
        compressor, generator, state = ctx.codec
        if isinstance(compressor, NoneCompressor):
            gz = g
        elif state is not None:
            comp, _ = compressor.compress_stateful(g, state)
            gz = comp.recon.to(g.dtype)
        else:   # a cold stateful compress is the plain one
            gz = compressor.compress(g, generator=generator).recon.to(g.dtype)
        return gz, None, None, None


def compress_downlink(z: torch.Tensor,
                      compressor: CutCompressor) -> torch.Tensor:
    """Downlink hook: identity forward; the backward pass sends the
    activation cotangent (C, ...) through ``compressor`` (nearest rounding)
    before it reaches the client. ``none`` returns it unchanged, bitwise."""
    return _CompressDownlink.apply(z, compressor, None, None)


def compress_downlink_keyed(z: torch.Tensor, generator: torch.Generator,
                            compressor: CutCompressor) -> torch.Tensor:
    """``compress_downlink`` with a generator (on the cotangent's device)
    for the backward codec: ``scalarq`` then rounds stochastically, an
    unbiased E[recon] = g, instead of to nearest."""
    return _CompressDownlink.apply(z, compressor, generator, None)


def compress_downlink_stateful(z: torch.Tensor, state: Any,
                               compressor: CutCompressor) -> torch.Tensor:
    """``compress_downlink`` with last round's codec state as an input: a
    ``pq`` downlink warm-starts Lloyd on the cotangent from ``state``'s
    codebooks. A backward pass cannot return new state, so the caller owns
    the lineage; ``None`` runs the cold round, as ``compress_downlink``."""
    return _CompressDownlink.apply(z, compressor, None, state)
