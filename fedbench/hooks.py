"""What the benchmark installs around the program's functions, each as a
context manager that puts the function back on exit. The program calls
these functions through their modules' attributes, so a replaced
attribute is what it calls.

  * ``Capture``: the quantizer's input and decisions on the training path
    (``repro_torch.core.correction.quantize``), for the checked steps;
  * ``KernelCalls``: the shape of every ``lloyd_update`` and
    ``pq_quantize`` call (``repro_torch.kernels.ops``), for the cut
    kernels' roofline, and optionally a span around every
    ``repro_torch.core.kmeans.batched_lloyd`` call;
  * ``CutGrad``: the gradient the server's backward hands the cut (what
    the eq.-5 correction's backward receives), at the first step;
  * the planted faults (the fault checks only): ``AlteredCodes`` (every
    100th code the training path's quantizer produces moves to the next
    centroid, and z̃ and the residual with it), ``FewerIterations`` (Lloyd
    runs one iteration fewer than configured), ``KmeansppSeeding`` (the
    seeds drawn by kmeans++ instead of farthest-point) and
    ``RoundedCodebooks`` (the codebooks rounded below the cut's dtype, z̃
    and the residual rebuilt from them).
"""

from __future__ import annotations

from typing import List

import torch


class Capture:
    """Each training-path quantize call's cut (rows, d), its decisions --
    the codebooks as shipped (C·R, L, d/q, in f32; the cut's dtype's
    values) and the codes (C·R, rows) -- and the f32 centroids its Lloyd
    run ended on (``centroids``), copied to ``device``."""

    def __init__(self, device="same"):
        self.device = device
        self.cuts, self.decisions, self.centroids = [], [], []

    def _keep(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        return t.clone() if self.device == "same" else t.to(self.device)

    def __enter__(self):
        from repro_torch.core import correction, kmeans
        self._saved = real, lloyd = correction.quantize, kmeans.batched_lloyd
        ended = []

        def batched_lloyd(*a, **kw):
            cents = lloyd(*a, **kw)
            ended.append(cents)
            return cents

        def quantize(z, cfg, *a, **kw):
            ended.clear()
            qb = real(z, cfg, *a, **kw)
            p = z.shape[0] * cfg.r
            self.cuts.append(self._keep(z.reshape(-1, z.shape[-1])))
            self.decisions.append((
                self._keep(qb.codebooks.reshape(p, cfg.num_clusters, -1)
                           .float()),
                self._keep(qb.codes.reshape(p, -1))))
            self.centroids.append(self._keep(ended[-1]))
            return qb
        correction.quantize = quantize
        kmeans.batched_lloyd = batched_lloyd
        return self

    def __exit__(self, *exc):
        from repro_torch.core import correction, kmeans
        correction.quantize, kmeans.batched_lloyd = self._saved
        return False


class KernelCalls:
    """``calls``: (kernel, P, N, D, L, itemsize) of each cut-kernel call
    while open. ``span_lloyd`` adds an obs span
    (``fedbench.batched_lloyd``) around every ``batched_lloyd`` call."""

    def __init__(self, span_lloyd: bool = False):
        self.calls: List[tuple] = []
        self.span_lloyd = span_lloyd

    def __enter__(self):
        from repro_torch import obs
        from repro_torch.core import kmeans
        from repro_torch.kernels import ops
        self._saved = (kmeans.batched_lloyd, ops.lloyd_update,
                       ops.pq_quantize)
        lloyd, upd, enc = self._saved

        def batched_lloyd(*a, **kw):
            with obs.span("fedbench.batched_lloyd", cat="fedbench"):
                return lloyd(*a, **kw)

        def shaped(name, fn):
            def call(x, cents, *a, **kw):
                p, n, d = x.shape
                size = x.element_size() if x.dtype in (
                    torch.float32, torch.bfloat16) else 4
                self.calls.append((name, p, n, d, cents.shape[1], size))
                return fn(x, cents, *a, **kw)
            return call
        if self.span_lloyd:
            kmeans.batched_lloyd = batched_lloyd
        ops.lloyd_update = shaped("lloyd_update", upd)
        ops.pq_quantize = shaped("pq_quantize", enc)
        return self

    def __exit__(self, *exc):
        from repro_torch.core import kmeans
        from repro_torch.kernels import ops
        kmeans.batched_lloyd, ops.lloyd_update, ops.pq_quantize = \
            self._saved
        return False


class CutGrad:
    """``grad``: the gradient arriving at the cut's z̃ in the first
    backward pass while open, copied to ``device``."""

    def __init__(self, device="cpu"):
        self.device, self.grad = device, None

    def __enter__(self):
        from repro_torch.core.correction import _QuantizeWithCorrection as fn
        self._saved = real = fn.backward

        def backward(ctx, g, *rest):
            if self.grad is None:
                self.grad = g.detach().to(self.device, copy=True)
            return real(ctx, g, *rest)
        fn.backward = staticmethod(backward)
        return self

    def __exit__(self, *exc):
        from repro_torch.core.correction import _QuantizeWithCorrection as fn
        fn.backward = staticmethod(self._saved)
        return False


def _rebuilt(qb, z, cfg, codes, cents):
    """``qb`` with z̃ and the residual rebuilt from (codes, f32 cents)."""
    c, n, d = z.shape
    p = c * cfg.r
    idx = codes.reshape(p, -1).long()
    zt = torch.gather(cents, 1, idx[..., None].expand(
        *idx.shape, cents.shape[-1]))
    zt = zt.reshape(c, cfg.q, n, -1).transpose(1, 2).reshape(c, n, d)
    return qb._replace(dequantized=zt.to(z.dtype), codes=codes,
                       residual=(z.float() - zt).to(z.dtype))


class _Patch:
    """Replaces ``module.attr`` by ``make(real)`` while open."""

    module, attr = "repro_torch.core.correction", "quantize"

    def make(self, real):
        raise NotImplementedError

    def __enter__(self):
        import importlib
        mod = importlib.import_module(self.module)
        self._saved = getattr(mod, self.attr)
        setattr(mod, self.attr, self.make(self._saved))
        return self

    def __exit__(self, *exc):
        import importlib
        setattr(importlib.import_module(self.module), self.attr,
                self._saved)
        return False


class AlteredCodes(_Patch):
    def make(self, real):
        def quantize(z, cfg, *a, **kw):
            qb = real(z, cfg, *a, **kw)
            codes = qb.codes.clone()
            codes[..., ::100] = (codes[..., ::100] + 1) % cfg.num_clusters
            cents = qb.codebooks.reshape(z.shape[0] * cfg.r,
                                         cfg.num_clusters, -1).float()
            return _rebuilt(qb, z, cfg, codes, cents)
        return quantize


class RoundedCodebooks(_Patch):
    """The codebooks at f16 where the cut is f32, at float8 e4m3 (one
    scale a codebook) where it is bf16."""

    def make(self, real):
        def quantize(z, cfg, *a, **kw):
            qb = real(z, cfg, *a, **kw)
            cb = qb.codebooks.float()
            if z.dtype == torch.float32:
                cb = cb.half().float()
            else:
                s = cb.abs().amax((-2, -1), keepdim=True).clamp_min(
                    1e-30) / 448.0
                cb = (cb / s).to(torch.float8_e4m3fn).float() * s
            cents = cb.reshape(z.shape[0] * cfg.r, cfg.num_clusters, -1)
            qb = _rebuilt(qb, z, cfg, qb.codes, cents)
            return qb._replace(codebooks=cb.to(z.dtype))
        return quantize


class FewerIterations(_Patch):
    module, attr = "repro_torch.core.kmeans", "batched_lloyd"

    def make(self, real):
        def batched_lloyd(x, num_clusters, num_iters=8, **kw):
            return real(x, num_clusters, max(num_iters - 1, 0), **kw)
        return batched_lloyd


class KmeansppSeeding(_Patch):
    module, attr = "repro_torch.core.kmeans", "_init_centroids"

    def make(self, real):
        def init(x, num_clusters, generator=None):
            if generator is None:
                generator = torch.Generator(x.device).manual_seed(0)
            return real(x, num_clusters, generator)
        return init


FAULTS = {"codes_altered": AlteredCodes,
          "codebooks_rounded": RoundedCodebooks,
          "kmeans_iters_minus_1": FewerIterations,
          "kmeans_random_seeds": KmeansppSeeding}
