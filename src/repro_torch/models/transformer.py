"""The split decoder LM of every family (twin of
``repro/models/transformer.py``).

A model is a repeated *period* of blocks (``cfg.layer_pattern``): dense
archs have the period ("attn",), jamba an 8-block mamba / attention
interleave; MoE FFNs replace dense FFNs on the positions selected by
(moe_period, moe_offset), with a shared expert beside them where
``cfg.shared_d_ff`` is set (its own ``shared`` leaves, on the MoE's normed
input; a ``moe.shared`` span). Weights of each position in the period are
stacked over periods (a leading axis of every leaf, the reference's layout)
and the periods run in a Python loop where the reference scans. In
training with ``cfg.remat`` each period is rematerialized in the backward
pass (``torch.utils.checkpoint``), and within a period of several blocks
each block again, so the backward pass holds one block's internals at a
time; ``remat_policy="dots"`` saves the matmul outputs of the period.

FedLite split: ``params = {"client": ..., "server": ...}``, nested dicts of
tensors. The client owns the embedding (and the vision projector) and the
first ``cfg.cut_periods`` periods; the server owns the rest, the final
norm and the LM head.
``client_forward`` emits the cut-layer activation, which ``cut_activation``
compresses per client -- each batch row (sequence) is one client, the
leading client axis of ``core/compressors.py`` and ``core/quantizer.py``.

Modalities: audio batches carry (B, K, S) token grids over K codebooks
(summed embeddings, one head per codebook, (B, S, K, V) logits and
(B, K, S) labels); vision batches carry precomputed patch embeddings
(``vision_embeds``), projected and put ahead of the text, and their own
M-RoPE positions (3, B, S).

Training: ``loss`` is the full FedLite forward (client -> PQ with the
corrected backward -> server -> cross-entropy plus the MoE balance loss);
``chunked_ce`` takes the CE over chunks of 512 positions, each chunk's
logits rematerialized in the backward pass.

Granite's multipliers (``PortArchConfig``): the embedding times
``embedding_multiplier``, each sublayer's output times
``residual_multiplier`` before its residual add, the logits (in
``logits``, so the CE and serving alike) divided by ``logits_scaling``;
at their defaults no operation is added.

Serving: ``prefill`` runs the prompt (its attention through the flash
kernel, see ``models/attention.py``), compresses the cut with the paper's
PQ when ``quantize=True`` (the two PQ kernels on a card), fills the KV and
SSM caches in place and returns the last token's logits; ``decode_step``
runs one token against the caches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import obs
from repro_torch.configs.base import ArchConfig
from repro_torch.core.compressors import (CutCompressor, CutState,
                                          PQCompressor, compress_downlink,
                                          compress_downlink_keyed,
                                          compress_with_correction_carry,
                                          compress_with_correction_stats)
from repro_torch.core.correction import quantize_with_correction_stats
from repro_torch.core.quantizer import PQConfig
from repro_torch.core.split import dtype_bits
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_init,
                                       dense_init, mlp_init, norm_init)
from repro_torch.sharding import ctx

Params = Dict[str, Any]


def _tree_map(fn: Callable, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree):
    """The tensors of a nested dict of params or caches, in key order."""
    if isinstance(tree, Mapping):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def _stack(trees):
    """A list of equally shaped nested dicts -> one dict of stacked leaves."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# the matmuls whose outputs remat_policy="dots" keeps (the reference's
# dots_with_no_batch_dims_saveable: products without batch dimensions)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, *args, dots: bool = False):
    """``fn(*args)`` rematerialized in the backward pass (all of it, or
    all but the matmul outputs with ``dots``)."""
    kw = {"context_fn": lambda: create_selective_checkpoint_contexts(
        _save_dots)} if dots else {}
    return checkpoint(fn, *args, use_reentrant=False, **kw)


@dataclasses.dataclass(frozen=True)
class TransformerLM:
    cfg: ArchConfig
    pq: Optional[PQConfig] = None     # FedLite quantizer at the cut layer
    lam: float = 0.0                  # gradient-correction strength (eq. 5)
    downlink_pq: Optional[PQConfig] = None  # legacy: PQ on the downlink
    # direction-agnostic cut-layer codecs (core/compressors.py): the uplink
    # compressor replaces the PQ fast path when set; the downlink compressor
    # squeezes the server->client gradient cotangent in the backward pass
    uplink_compressor: Optional[CutCompressor] = None
    downlink_compressor: Optional[CutCompressor] = None

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> Params:
        """Random weights with the reference's distributions, drawn from
        ``generator`` (on ``device``; None = the default generator, as on
        the ``meta`` device)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.param_dtype)
        K = cfg.num_codebooks

        def per_codebook(init):
            return torch.stack([init() for _ in range(K)]) if K > 1 \
                else init()

        client: Params = {"tok_embed": per_codebook(
            lambda: embed_init(generator, cfg.padded_vocab, cfg.d_model,
                               dtype, device=device))}
        if cfg.vision_embed_dim:
            client["vision_proj"] = dense_init(
                generator, cfg.vision_embed_dim, cfg.d_model, dtype,
                device=device)
        client["layers"] = self._init_stack(generator, cfg.cut_periods,
                                            dtype, device)
        server: Params = {
            "layers": self._init_stack(
                generator, cfg.num_periods - cfg.cut_periods, dtype, device),
            "final_norm": norm_init(cfg.d_model, cfg.norm_type, dtype,
                                    device=device),
        }
        if not cfg.tie_embeddings:
            server["head"] = per_codebook(
                lambda: dense_init(generator, cfg.d_model, cfg.padded_vocab,
                                   dtype, device=device))
        return {"client": client, "server": server}

    def _init_stack(self, generator, n_periods: int, dtype,
                    device) -> Params:
        cfg = self.cfg

        def init_period():
            p = {}
            for pos in range(cfg.period):
                lp = {"ln1": norm_init(cfg.d_model, cfg.norm_type, dtype,
                                       device=device),
                      "ln2": norm_init(cfg.d_model, cfg.norm_type, dtype,
                                       device=device)}
                init = attn_mod.attn_init \
                    if cfg.layer_pattern[pos] == "attn" else ssm_mod.ssm_init
                lp["mixer"] = init(generator, cfg, dtype, device=device)
                if self._pos_is_moe(pos):
                    lp["ffn"] = moe_mod.moe_init(generator, cfg, dtype,
                                                 device=device)
                    if cfg.shared_d_ff:
                        lp["shared"] = mlp_init(
                            generator, cfg.d_model, cfg.shared_d_ff,
                            cfg.mlp_type, False, dtype, device=device)
                elif cfg.d_ff:
                    lp["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff,
                                         cfg.mlp_type, cfg.use_bias, dtype,
                                         device=device)
                p[f"p{pos}"] = lp
            return p

        if n_periods == 0:
            return {}
        return _stack([init_period() for _ in range(n_periods)])

    def _pos_is_moe(self, pos: int) -> bool:
        # position-static across periods: period % moe_period == 0 and the
        # cut is a whole number of periods
        return bool(self.cfg.num_experts) and \
            (pos % self.cfg.moe_period == self.cfg.moe_offset)

    # ----------------------------------------------------------- embeddings
    def embed(self, client_params: Params, batch) -> torch.Tensor:
        """Token embeddings (B, S, D) in the compute dtype: summed over the
        codebooks of a (B, K, S) grid; a vision batch's projected patch
        embeddings ahead of the text. The lookup is ``F.embedding``, whose
        backward sums in a fixed order on the card."""
        cfg = self.cfg
        emb, tokens = client_params["tok_embed"], batch["tokens"]
        if cfg.num_codebooks > 1:       # audio: (B, K, S) token grid
            x = sum(F.embedding(tokens[:, k], emb[k])
                    for k in range(cfg.num_codebooks))
        else:
            x = F.embedding(tokens, emb)
        if cfg.scale_embed:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        if cfg.embedding_multiplier != 1.0:
            x = x * cfg.embedding_multiplier
        if cfg.vision_embed_dim and "vision_embeds" in batch:
            vis = batch["vision_embeds"].to(x.dtype) \
                @ client_params["vision_proj"]
            x = torch.cat([vis, x], dim=1)
        return ctx.shard_residual(x.to(cfg.compute_dtype))

    # ------------------------------------------------------------- periods
    def _training(self, mode: str) -> bool:
        """Rematerialize in this pass: a training forward under autograd
        with ``cfg.remat``."""
        return mode == "train" and self.cfg.remat and torch.is_grad_enabled()

    def _apply_period(self, pp: Params, x, positions, mode, caches,
                      decode_pos):
        """One period's blocks -> (x, aux). ``caches`` are written in
        place."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # nested remat: with a period of several blocks (jamba's 8), one
        # checkpoint for the whole period would hold every block's
        # internals (SSD chunk stacks, MoE buffers) alive at once in the
        # backward pass; a checkpoint per block holds one block's
        inner = self._training(mode) and cfg.period > 1

        def run(fn, *args):
            return _remat(fn, *args) if inner else fn(*args)

        def residual(y):
            """A sublayer's output as its residual add takes it."""
            rm = cfg.residual_multiplier
            return y if rm == 1.0 else y * rm

        for pos in range(cfg.period):
            lp = pp[f"p{pos}"]
            cache = caches[f"p{pos}"] if caches is not None else None
            if cfg.layer_pattern[pos] == "attn":
                def mixer_fn(lp_, x_):
                    h = apply_norm(lp_["ln1"], x_, cfg.norm_type,
                                   cfg.norm_eps)
                    return residual(attn_mod.apply_attention(
                        lp_["mixer"], h, cfg, positions, mode=mode,
                        cache=cache, decode_pos=decode_pos)[0])
            else:
                def mixer_fn(lp_, x_):
                    h = apply_norm(lp_["ln1"], x_, cfg.norm_type,
                                   cfg.norm_eps)
                    return residual(ssm_mod.apply_ssm(
                        lp_["mixer"], h, cfg, mode=mode, cache=cache)[0])
            x = x + run(mixer_fn, lp, x)
            if "ffn" not in lp:
                continue
            if self._pos_is_moe(pos):
                def ffn_fn(lp_, x_):
                    h = apply_norm(lp_["ln2"], x_, cfg.norm_type,
                                   cfg.norm_eps)
                    y, a = moe_mod.apply_moe(lp_["ffn"], h, cfg)
                    if "shared" in lp_:
                        with obs.span("moe.shared", cat="moe",
                                      width=cfg.shared_d_ff):
                            y = y + apply_mlp(lp_["shared"], h,
                                              cfg.mlp_type)
                    return residual(y), a
                y, a = run(ffn_fn, lp, x)
                aux = aux + a
            else:
                def ffn_fn(lp_, x_):
                    h = apply_norm(lp_["ln2"], x_, cfg.norm_type,
                                   cfg.norm_eps)
                    return residual(apply_mlp(lp_["ffn"], h, cfg.mlp_type))
                y = run(ffn_fn, lp, x)
            x = x + y
        return x, aux

    def _run_stack(self, layers: Params, x, positions, mode, caches,
                   decode_pos):
        """Run the stacked periods in order; ``caches`` (stacked like the
        layers, or None) are written in place through per-period views.
        Returns (x, caches, aux), aux the MoE balance loss summed over the
        periods (f32)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if not layers:
            return x, caches, aux
        remat = self._training(mode)
        dots = self.cfg.remat_policy == "dots"
        n = next(tree_leaves(layers)).shape[0]
        for i in range(n):
            pslice = _tree_map(lambda t: t[i], layers)
            cslice = None if caches is None else \
                _tree_map(lambda t: t[i], caches)
            if remat:
                x, a = _remat(lambda pp, x_: self._apply_period(
                    pp, x_, positions, mode, None, None), pslice, x,
                    dots=dots)
            else:
                x, a = self._apply_period(pslice, x, positions, mode, cslice,
                                          decode_pos)
            aux = aux + a
        return x, caches, aux

    # ------------------------------------------------------- fedlite split
    def client_forward(self, client_params: Params, batch, *, mode="train",
                       caches=None, decode_pos=None):
        """Embed + first cut_periods periods -> cut-layer activation."""
        x = self.embed(client_params, batch)
        positions = self._positions(batch, x.shape[1], decode_pos)
        return self._run_stack(client_params["layers"], x, positions, mode,
                               caches, decode_pos)

    def _downlink(self) -> Optional[CutCompressor]:
        if self.downlink_compressor is not None:
            return self.downlink_compressor
        if self.downlink_pq is not None:       # legacy PQConfig field
            return PQCompressor(self.downlink_pq)
        return None

    def cut_activation(self, x: torch.Tensor, *, quantize: bool,
                       lam_override=None,
                       key: Optional[torch.Generator] = None,
                       cut_state: Optional[CutState] = None
                       ) -> Tuple[torch.Tensor, Dict]:
        """Apply the cut-layer codecs (paper Fig. 1 generalized) at the cut.

        Each batch row (sequence) is one client, with its own codebooks:
        x (B, S, d) is the codecs' (C, n, d) with C = B.

        Uplink: ``pq`` (the paper's grouped PQ with the corrected backward
        pass) unless ``uplink_compressor`` overrides it. Downlink:
        ``downlink_compressor`` squeezes the activation cotangent in the
        backward pass; ``None``/"none" leaves it untouched bitwise.

        ``cut_state`` (leaves with a leading client axis) routes the uplink
        through the state-carrying hook (codebook warm start, optional error
        feedback); the new state comes back under ``stats["cut_state"]``.
        ``key``, a ``torch.Generator`` on x's device, makes the downlink
        codec round stochastically.
        """
        up = self.uplink_compressor
        dl = self._downlink()
        has_up = quantize and (up is not None or self.pq is not None)
        has_dl = quantize and dl is not None and dl.name != "none"
        if not has_up and not has_dl:
            return x, {}
        # gather each client's (sequence-sharded) activation so the
        # per-client compression runs on one rank -- exactly what a real
        # client does -- and the codecs (and the kernels) see plain local
        # rows
        x = ctx.shard(x, ctx.BATCH, None, None)
        lam = self.lam if lam_override is None else lam_override
        clients, n_per_client, d = x.shape  # tokens per client = sequence
        phi = dtype_bits(self.cfg.compute_dtype)

        def pq_bits():
            return {"pq_message_bits": float(
                        clients * self.pq.message_bits(n_per_client, d)),
                    "pq_compression_ratio": float(
                        self.pq.compression_ratio(n_per_client, d))}

        def uplink_bits():
            msg = up.analytic_bits(n_per_client, d, phi_bits=phi)
            return {"uplink_message_bits": float(clients * msg),
                    "uplink_compression_ratio":
                        phi * n_per_client * d / max(msg, 1)}

        if ctx.is_sharded(x) and cut_state is not None:
            raise NotImplementedError(
                "cut_activation: a carried cut_state under a (data, model) "
                "mesh is not supported; the cohort-parallel clients mesh "
                "(federated/executor.py) carries cut states")

        def codecs(x):
            """The uplink and downlink codecs of the (local) clients:
            (z̃, per-client distortion or None, the next cut state)."""
            z_tilde, dist, new_state = x, None, None
            if has_up and cut_state is not None:
                comp = up if up is not None else PQCompressor(self.pq)
                z_tilde, dist, new_state = compress_with_correction_carry(
                    x, lam, cut_state, comp)
            elif has_up and up is None:
                # the PQ fast path: fused backend encode + residual reuse
                z_tilde, dist = quantize_with_correction_stats(x, lam,
                                                               self.pq)
            elif has_up:
                z_tilde, dist = compress_with_correction_stats(x, lam, up)
            if has_dl:
                z_tilde = compress_downlink(z_tilde, dl) if key is None \
                    else compress_downlink_keyed(z_tilde, key, dl)
            return z_tilde, dist, new_state

        rows = ctx.batch_entry(clients)
        z_tilde, dist, new_state = ctx.local(
            codecs, (ctx.P(rows, None, None),
                     ctx.P(rows) if has_up else None, None),
            (ctx.P(rows, None, None),))(x)
        stats = {}
        if has_up:
            stats["pq_distortion"] = dist.mean()
            if new_state is not None:
                stats["cut_state"] = new_state
            stats.update(pq_bits() if up is None else uplink_bits())
        if has_dl:
            stats["downlink_message_bits"] = float(
                clients * dl.analytic_bits(n_per_client, d, phi_bits=phi))
        return ctx.shard_residual(z_tilde), stats

    def server_forward(self, server_params: Params, acts, batch, *,
                       mode="train", caches=None, decode_pos=None):
        positions = self._positions(batch, acts.shape[1], decode_pos)
        x, new_caches, aux = self._run_stack(server_params["layers"], acts,
                                             positions, mode, caches,
                                             decode_pos)
        x = apply_norm(server_params["final_norm"], x, self.cfg.norm_type,
                       self.cfg.norm_eps)
        return x, new_caches, aux

    def head_matrix(self, params: Params) -> torch.Tensor:
        """(D, Vp) LM head, (K, D, Vp) with K codebooks; the transposed
        embedding table when tied."""
        if self.cfg.tie_embeddings:
            head = params["client"]["tok_embed"].transpose(-1, -2)
        else:
            head = params["server"]["head"]
        if self.cfg.num_codebooks > 1:
            head = ctx.shard(head, None, "data", "model")
        else:
            head = ctx.shard(head, "data", "model")
        # gathered once here, outside the CE chunks
        return ctx.gathered(head)

    def logits(self, params: Params, x: torch.Tensor,
               head: Optional[torch.Tensor] = None) -> torch.Tensor:
        """f32 logits (B, S, Vp), or (B, S, K, Vp) with K codebooks."""
        head = head if head is not None else self.head_matrix(params)
        x = ctx.shard(x, ctx.BATCH, None, None)   # the sequence gathered
        if self.cfg.num_codebooks > 1:
            # on each rank's rows and vocabulary block: DTensor would merge
            # the codebooks with the split vocabulary into one dim
            rows = ctx.batch_entry(x.shape[0])
            vocab = ctx.spec_of(head)[2] if ctx.is_sharded(head) else None
            out = ctx.local(
                lambda x, h: torch.einsum("bsd,kdv->bskv", x, h),
                ctx.P(rows, None, None, vocab),
                (ctx.P(rows, None, None), ctx.P(None, None, vocab)))(
                x, head.to(x.dtype)).float()
        else:
            out = (x @ head.to(x.dtype)).float()
        if self.cfg.logits_scaling != 1.0:
            out = out / self.cfg.logits_scaling
        return ctx.shard(out, ctx.BATCH, None, "model")

    # ------------------------------------------------------------- losses
    def loss(self, params: Params, batch, *, quantize: bool = True,
             lam_override=None, key: Optional[torch.Generator] = None,
             cut_state: Optional[CutState] = None):
        """Full FedLite forward: client -> PQ (+ corrected backward) ->
        server -> CE. Returns (ce + aux, metrics); the metrics are
        detached (``cut_state`` passes through)."""
        acts, _, aux_c = self.client_forward(params["client"], batch,
                                             mode="train")
        acts, pq_stats = self.cut_activation(acts, quantize=quantize,
                                             lam_override=lam_override,
                                             key=key, cut_state=cut_state)
        x, _, aux_s = self.server_forward(params["server"], acts, batch,
                                          mode="train")
        ce = self.chunked_ce(params, x, batch["labels"])
        aux = aux_c + aux_s
        metrics = {"ce": ce, "aux": aux, **pq_stats}
        metrics = {k: v.detach() if torch.is_tensor(v) else v
                   for k, v in metrics.items()}
        return ce + aux, metrics

    def chunked_ce(self, params: Params, x: torch.Tensor,
                   labels: torch.Tensor, chunk: int = 512) -> torch.Tensor:
        """Mean CE over the valid labels without the full (B, S, V) logits:
        a loop over sequence chunks, each chunk's logits rematerialized in
        the backward pass. Full logits when ``chunk`` does not divide S or
        S <= chunk."""
        if self.cfg.num_codebooks > 1:
            labels = labels.movedim(1, 2)                # (B, S, K)
        count = (labels >= 0).sum().clamp_min(1)
        S = x.shape[1]
        if S % chunk != 0 or S <= chunk:
            return self._ce_sum(self.logits(params, x), labels) / count
        head = self.head_matrix(params)
        remat = torch.is_grad_enabled()

        def body(xb, lb):
            return self._ce_sum(self.logits(params, xb, head=head), lb)

        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, S, chunk):
            xb, lb = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
            tot = tot + (_remat(body, xb, lb) if remat else body(xb, lb))
        return tot / count

    def _ce_sum(self, logits: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        """Sum of the masked token CE; labels already (B, S[, K]), −1
        masked; the padded vocabulary's logits set to −1e30."""
        vocab_ok = torch.arange(logits.shape[-1], device=logits.device) \
            < self.cfg.vocab_size
        logits = torch.where(vocab_ok, logits, -1e30)
        mask = labels >= 0
        safe = labels.clamp_min(0)
        lse = torch.logsumexp(logits, dim=-1)
        return ((lse - self._picked(logits, safe)) * mask).sum()

    def _picked(self, logits: torch.Tensor,
                labels: torch.Tensor) -> torch.Tensor:
        """Each label's logit. Under a mesh each rank picks from its own
        block of the vocabulary (zero where the label lies outside it), a
        partial sum over "model": the gather's backward then scatters
        into local blocks, not into a (rows, S, V) tensor on every
        rank."""
        vocab = ctx.model_entry(logits.shape[-1]) \
            if ctx.is_sharded(logits) else None
        inner = (None,) * (logits.ndim - 2)
        lspec = ctx.P(ctx.batch_entry(logits.shape[0]), *inner)

        def pick(lg, lab):
            n = lg.shape[-1]
            idx = lab - n * ctx.axis_rank("model") if vocab else lab
            inside = (idx >= 0) & (idx < n)
            got = lg.gather(-1, idx.clamp(0, n - 1)[..., None])[..., 0]
            return torch.where(inside, got, 0.0)

        return ctx.local(pick, ctx.Sum(lspec, vocab),
                         (ctx.P(*lspec, vocab), lspec))(logits, labels)

    def token_ce(self, logits: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        """Mean CE of full logits: (B, S, V) against (B, S), or (B, S, K, V)
        against (B, K, S)."""
        if self.cfg.num_codebooks > 1:
            labels = labels.movedim(1, 2)                # (B, S, K)
        return self._ce_sum(logits, labels) / (labels >= 0).sum() \
            .clamp_min(1)

    # --------------------------------------------------------- inference
    def init_caches(self, batch_size: int, max_len: int,
                    device="cuda") -> Params:
        """Zeroed KV and SSM caches, stacked over periods like the
        layers."""
        cfg = self.cfg

        def cache(pos):
            if cfg.layer_pattern[pos] == "attn":
                return attn_mod.init_attn_cache(cfg, batch_size, max_len,
                                                cfg.compute_dtype,
                                                device=device)
            return ssm_mod.init_ssm_cache(cfg, batch_size, cfg.compute_dtype,
                                          device=device)

        def stack_caches(n_periods):
            if n_periods == 0:
                return {}
            per = {f"p{pos}": cache(pos) for pos in range(cfg.period)}
            return _tree_map(
                lambda t: t.expand(n_periods, *t.shape).clone(), per)

        return {"client": stack_caches(cfg.cut_periods),
                "server": stack_caches(cfg.num_periods - cfg.cut_periods)}

    def prefill(self, params: Params, batch, caches, *,
                quantize: bool = False):
        """Process the prompt, fill ``caches`` (in place), return the last
        token's logits (B, 1, Vp) f32 and the caches.

        ``quantize=True`` compresses the cut-layer activation with the
        paper's PQ before it crosses the client->server link (split
        inference)."""
        acts, c_caches, _ = self.client_forward(
            params["client"], batch, mode="prefill", caches=caches["client"])
        acts, _ = self.cut_activation(acts, quantize=quantize)
        x, s_caches, _ = self.server_forward(
            params["server"], acts, batch, mode="prefill",
            caches=caches["server"])
        lg = self.logits(params, x[:, -1:])
        return lg, {"client": c_caches, "server": s_caches}

    def decode_step(self, params: Params, caches, tokens: torch.Tensor,
                    decode_pos: int):
        """One token (B, 1), or (B, K, 1) with K codebooks, at absolute
        position ``decode_pos``."""
        batch = {"tokens": tokens}
        acts, c_caches, _ = self.client_forward(
            params["client"], batch, mode="decode", caches=caches["client"],
            decode_pos=decode_pos)
        x, s_caches, _ = self.server_forward(
            params["server"], acts, batch, mode="decode",
            caches=caches["server"], decode_pos=decode_pos)
        lg = self.logits(params, x)
        return lg, {"client": c_caches, "server": s_caches}

    # ------------------------------------------------------------- helpers
    def _positions(self, batch, seq_len: int, decode_pos):
        """The batch's own positions; else (B, 1) ids of ``decode_pos`` in
        decode, or None (0..S−1 for every row: the flash prefill's case)."""
        if "positions" in batch:
            return batch["positions"]
        if decode_pos is None:
            return None
        tokens = batch["tokens"]
        return attn_mod.default_positions(
            tokens.shape[0], 1, tokens.device,
            self.cfg.mrope_sections is not None, start=decode_pos)


def from_jax_params(params) -> Params:
    """The reference's nested params (numpy arrays, or anything
    ``np.asarray`` takes) -> the port's, leaf for leaf, on the CPU, with
    the same keys, layouts and dtypes (bf16 included)."""
    def convert(leaf):
        a = np.asarray(leaf)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return _tree_map(convert, params)
