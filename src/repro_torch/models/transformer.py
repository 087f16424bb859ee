"""The split decoder LM, dense attention families (twin of
``repro/models/transformer.py``).

A model is a repeated *period* of blocks (``cfg.layer_pattern``); dense
archs have the period ("attn",). Weights of each position in the period are
stacked over periods (a leading axis of every leaf, the reference's layout)
and the periods run in a Python loop where the reference scans.

FedLite split: ``params = {"client": ..., "server": ...}``, nested dicts of
tensors. The client owns the embedding and the first ``cfg.cut_periods``
periods; the server owns the rest, the final norm and the LM head.
``client_forward`` emits the cut-layer activation, which ``cut_activation``
compresses per client -- each batch row (sequence) is one client, the
leading client axis of ``core/compressors.py`` and ``core/quantizer.py``.

Serving: ``prefill`` runs the prompt (its attention through the flash
kernel, see ``models/attention.py``), compresses the cut with the paper's
PQ when ``quantize=True`` (the two PQ kernels on a card), fills the KV
caches in place and returns the last token's logits; ``decode_step`` runs
one token against the caches.

Not ported yet, each raising ``NotImplementedError``: MoE and SSM blocks,
multi-codebook (audio) and vision inputs (ROADMAP A15, the rest of the
transformer stack), and the LM's training loss (``loss``, ``chunked_ce``,
``_ce_sum``, ``token_ce``: ROADMAP A15, LM training).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

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
from repro_torch.models.layers import (apply_mlp, apply_norm, embed_init,
                                       dense_init, mlp_init, norm_init)

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


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP A15)")


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

    def __post_init__(self):
        cfg = self.cfg
        if cfg.num_experts:
            _not_ported(f"{cfg.name}: MoE blocks")
        if any(kind != "attn" for kind in cfg.layer_pattern):
            _not_ported(f"{cfg.name}: SSM blocks")
        if cfg.num_codebooks > 1:
            _not_ported(f"{cfg.name}: multi-codebook inputs")
        if cfg.vision_embed_dim:
            _not_ported(f"{cfg.name}: vision inputs")

    # ------------------------------------------------------------------ init
    def init(self, generator: Optional[torch.Generator] = None,
             device="cuda") -> Params:
        """Random weights with the reference's distributions, drawn from
        ``generator`` (on ``device``; None = the default generator, as on
        the ``meta`` device)."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.param_dtype)
        client: Params = {
            "tok_embed": embed_init(generator, cfg.padded_vocab, cfg.d_model,
                                    dtype, device=device),
            "layers": self._init_stack(generator, cfg.cut_periods, dtype,
                                       device),
        }
        server: Params = {
            "layers": self._init_stack(
                generator, cfg.num_periods - cfg.cut_periods, dtype, device),
            "final_norm": norm_init(cfg.d_model, cfg.norm_type, dtype,
                                    device=device),
        }
        if not cfg.tie_embeddings:
            server["head"] = dense_init(generator, cfg.d_model,
                                        cfg.padded_vocab, dtype,
                                        device=device)
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
                                       device=device),
                      "mixer": attn_mod.attn_init(generator, cfg, dtype,
                                                  device=device)}
                if cfg.d_ff:
                    lp["ffn"] = mlp_init(generator, cfg.d_model, cfg.d_ff,
                                         cfg.mlp_type, cfg.use_bias, dtype,
                                         device=device)
                p[f"p{pos}"] = lp
            return p

        if n_periods == 0:
            return {}
        return _stack([init_period() for _ in range(n_periods)])

    # ----------------------------------------------------------- embeddings
    def embed(self, client_params: Params, batch) -> torch.Tensor:
        cfg = self.cfg
        x = client_params["tok_embed"][batch["tokens"]]
        if cfg.scale_embed:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
        return x.to(cfg.compute_dtype)

    # ------------------------------------------------------------- periods
    def _apply_period(self, pp: Params, x, positions, mode, caches,
                      decode_pos):
        cfg = self.cfg
        for pos in range(cfg.period):
            lp = pp[f"p{pos}"]
            cache = caches[f"p{pos}"] if caches is not None else None
            h = apply_norm(lp["ln1"], x, cfg.norm_type, cfg.norm_eps)
            y, _ = attn_mod.apply_attention(lp["mixer"], h, cfg, positions,
                                            mode=mode, cache=cache,
                                            decode_pos=decode_pos)
            x = x + y
            if "ffn" in lp:
                h = apply_norm(lp["ln2"], x, cfg.norm_type, cfg.norm_eps)
                x = x + apply_mlp(lp["ffn"], h, cfg.mlp_type)
        return x

    def _run_stack(self, layers: Params, x, positions, mode, caches,
                   decode_pos):
        """Run the stacked periods in order; ``caches`` (stacked like the
        layers, or None) are written in place through per-period views.
        Returns (x, caches, aux); aux, the MoE balance loss, is 0 here."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if not layers:
            return x, caches, aux
        n = next(tree_leaves(layers)).shape[0]
        for i in range(n):
            pslice = _tree_map(lambda t: t[i], layers)
            cslice = None if caches is None else \
                _tree_map(lambda t: t[i], caches)
            x = self._apply_period(pslice, x, positions, mode, cslice,
                                   decode_pos)
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
        lam = self.lam if lam_override is None else lam_override
        clients, n_per_client, d = x.shape  # tokens per client = sequence
        phi = dtype_bits(self.cfg.compute_dtype)
        z_tilde, stats = x, {}

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

        if has_up and cut_state is not None:
            comp = up if up is not None else PQCompressor(self.pq)
            z_tilde, dist, new_state = compress_with_correction_carry(
                x, lam, cut_state, comp)
            stats = {"pq_distortion": dist.mean(), "cut_state": new_state}
            stats.update(pq_bits() if up is None else uplink_bits())
        elif has_up and up is None:
            # the PQ fast path: fused backend encode + residual reuse
            z_tilde, dist = quantize_with_correction_stats(x, lam, self.pq)
            stats = {"pq_distortion": dist.mean(), **pq_bits()}
        elif has_up:
            z_tilde, dist = compress_with_correction_stats(x, lam, up)
            stats = {"pq_distortion": dist.mean(), **uplink_bits()}
        if has_dl:
            z_tilde = compress_downlink(z_tilde, dl) if key is None \
                else compress_downlink_keyed(z_tilde, key, dl)
            stats["downlink_message_bits"] = float(
                clients * dl.analytic_bits(n_per_client, d, phi_bits=phi))
        return z_tilde, stats

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
        """(D, Vp) LM head; the transposed embedding table when tied."""
        if self.cfg.tie_embeddings:
            return params["client"]["tok_embed"].T
        return params["server"]["head"]

    def logits(self, params: Params, x: torch.Tensor,
               head: Optional[torch.Tensor] = None) -> torch.Tensor:
        head = head if head is not None else self.head_matrix(params)
        return (x @ head.to(x.dtype)).float()

    # ------------------------------------------------------------- losses
    def loss(self, params, batch, **kwargs):
        _not_ported("the LM's training loss")

    def chunked_ce(self, params, x, labels, chunk: int = 512):
        _not_ported("the LM's training loss")

    def _ce_sum(self, logits, labels):
        _not_ported("the LM's training loss")

    def token_ce(self, logits, labels):
        _not_ported("the LM's training loss")

    # --------------------------------------------------------- inference
    def init_caches(self, batch_size: int, max_len: int,
                    device="cuda") -> Params:
        """Zeroed KV caches, stacked over periods like the layers."""
        cfg = self.cfg

        def stack_caches(n_periods):
            if n_periods == 0:
                return {}
            per = {f"p{pos}": attn_mod.init_attn_cache(
                       cfg, batch_size, max_len, cfg.compute_dtype,
                       device=device)
                   for pos in range(cfg.period)}
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
        """One token (B, 1) at absolute position ``decode_pos``."""
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
