"""The split Mixtral LM's training step, plainly, in f32 (arXiv:2401.04088,
with the cut and the routing of the configuration's file).

Embedding; each layer pre-norm: x + attention(RMSNorm(x)), then
x + MoE(RMSNorm(x)). Attention: GQA (query head h reads key/value head
h // (H / Kv)), RoPE on the two halves of each head (θ from the config),
causal within the sliding window, softmax in f32. MoE: an f32 router,
softmax over the experts, the top k (the lower index first on a tie),
their weights renormalized; each expert takes at most C = max(8,
ceil8(ceil(k·N/E·capacity))) (token, choice) pairs, ranked in token-major
order, and a pair past C adds nothing; each expert is a SwiGLU
(silu(x·Wg) ⊙ (x·Wu))·Wd; the Switch balance loss E·Σ_e mean p_e ·
mean chosen_e, times its weight. The client holds the embedding and the
first ``cut_periods`` layers; each sequence is one client, and its cut
(S, d) goes through FedLite's grouped PQ with the eq.-5 corrected
backward. The server holds the other layers, the final norm and the head;
the loss is the mean CE over the labels that are not −1 plus both sides'
balance losses.

Params are a flat dict keyed by '/'-joined paths (layers stacked on a
leading axis of one period each), as ``param_specs`` lists them. Each
layer is rematerialized in the backward pass, the attention runs in
blocks of query rows and the CE in blocks of positions, so the f32 step of
the full widths fits one card. The products' inputs go through
``lowprec`` (a weight's product through ``lowprec.product``, which keeps
no rounded copy of the weight); the router stays in f32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fedbench.reference import lowprec, pq

Q_BLOCK = 512
CE_BLOCK = 512


def param_specs(m: dict) -> Dict[str, tuple]:
    """{key: (shape, dtype name)} of the params, from the config's
    ``model``."""
    d, hd, e, f = m["d_model"], m["head_dim"], m["num_experts"], m["d_ff"]
    q, kv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    v = -(-m["vocab_size"] // m["vocab_pad_to"]) * m["vocab_pad_to"]
    pdt = m["param_dtype"]

    def layer(side):
        pre = f"{side}/layers/p0"
        return {f"{pre}/ln1/scale": ((1, d), pdt),
                f"{pre}/ln2/scale": ((1, d), pdt),
                f"{pre}/mixer/wq": ((1, d, q), pdt),
                f"{pre}/mixer/wk": ((1, d, kv), pdt),
                f"{pre}/mixer/wv": ((1, d, kv), pdt),
                f"{pre}/mixer/wo": ((1, q, d), pdt),
                f"{pre}/ffn/router": ((1, d, e), "float32"),
                f"{pre}/ffn/we_gate": ((1, e, d, f), pdt),
                f"{pre}/ffn/we_up": ((1, e, d, f), pdt),
                f"{pre}/ffn/we_down": ((1, e, f, d), pdt)}
    if m["num_layers"] != 2 or m["cut_periods"] != 1:
        raise ValueError("the reference lays out one layer a side")
    return {"client/tok_embed": ((v, d), pdt), **layer("client"),
            **layer("server"), "server/final_norm/scale": ((d,), pdt),
            "server/head": ((d, v), pdt)}


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd) rotated at positions 0..S−1."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, device=x.device,
                                    dtype=torch.float32) / half)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] \
        * freqs
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(p, x, m, r, mm):
    b, s, d = x.shape
    h, kv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    g = h // kv
    q = rope(mm(x, p["wq"][0]).reshape(b, s, h, hd), m["rope_theta"])
    k = rope(mm(x, p["wk"][0]).reshape(b, s, kv, hd), m["rope_theta"])
    v = mm(x, p["wv"][0]).reshape(b, s, kv, hd)
    qg = r(q).reshape(b, s, kv, g, hd)
    kr, vr = r(k), r(v)
    pos = torch.arange(s, device=x.device)
    window = m.get("sliding_window")
    outs = []
    for i in range(0, s, Q_BLOCK):
        sc = torch.einsum("bqkgh,bskh->bkgqs", qg[:, i:i + Q_BLOCK], kr) \
            / math.sqrt(hd)
        qp = pos[i:i + Q_BLOCK, None]
        keep = qp >= pos[None, :]
        if window is not None:
            keep &= (qp - pos[None, :]) < window
        pr = torch.softmax(sc.masked_fill(~keep, float("-inf")), -1)
        outs.append(torch.einsum("bkgqs,bskh->bqkgh", r(pr), vr))
    o = torch.cat(outs, 1).reshape(b, s, h * hd)
    return mm(o, p["wo"][0])


def capacity(m: dict, tokens: int) -> int:
    c = int(math.ceil(m["experts_per_token"] * tokens / m["num_experts"]
                      * m["capacity_factor"]))
    return max(8, -(-c // 8) * 8)


def moe(p, x, m, mm):
    """(y, balance loss)."""
    b, s, d = x.shape
    e, k = m["num_experts"], m["experts_per_token"]
    xf = x.reshape(b * s, d)
    probs = torch.softmax(xf @ p["router"][0], -1)
    rest, idx = probs.detach().clone(), []
    for _ in range(k):
        i = rest.argmax(-1)
        idx.append(i)
        rest[torch.arange(rest.shape[0], device=x.device), i] = -math.inf
    idx = torch.stack(idx, -1)                              # (N, k)
    w = probs.gather(-1, idx)
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    flat = idx.reshape(-1)
    onehot = F.one_hot(flat, e)
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
    kept = pos < capacity(m, b * s)
    y = torch.zeros_like(xf)
    for j in range(e):
        pairs = torch.nonzero((flat == j) & kept)[:, 0]
        tok = pairs // k
        xe = xf[tok]
        he = F.silu(mm(xe, p["we_gate"][0, j])) * mm(xe, p["we_up"][0, j])
        ye = mm(he, p["we_down"][0, j])
        y = y.index_add(0, tok, ye * w[tok, pairs % k][:, None])
    chosen = F.one_hot(idx, e).float().sum(1)
    aux = e * (probs.mean(0) * chosen.mean(0)).sum() * m["router_aux_weight"]
    return y.reshape(b, s, d), aux


def block(p, x, m, r, mm):
    eps = m["norm_eps"]
    x = x + attention({k.split("/")[-1]: v for k, v in p.items()
                       if "/mixer/" in k},
                      rms_norm(x, p_of(p, "ln1/scale"), eps), m, r, mm)
    y, aux = moe({k.split("/")[-1]: v for k, v in p.items() if "/ffn/" in k},
                 rms_norm(x, p_of(p, "ln2/scale"), eps), m, mm)
    return x + y, aux


def p_of(p, suffix):
    (v,) = [t for k, t in p.items() if k.endswith(suffix)]
    return v[0]


def layer_params(params, side):
    pre = f"{side}/layers/p0/"
    return {k: v for k, v in params.items() if k.startswith(pre)}


def ce_sum(x, head, labels, mm):
    def body(xb, lb):
        logits = mm(xb, head)
        lse = torch.logsumexp(logits, -1)
        got = logits.gather(-1, lb.clamp_min(0)[..., None])[..., 0]
        return ((lse - got) * (lb >= 0)).sum()
    tot = x.new_zeros(())
    for i in range(0, x.shape[1], CE_BLOCK):
        tot = tot + checkpoint(body, x[:, i:i + CE_BLOCK],
                               labels[:, i:i + CE_BLOCK], use_reentrant=False)
    return tot


def client_cut(params, tokens, m, r, mm):
    x = F.embedding(tokens, params["client/tok_embed"])
    lp = layer_params(params, "client")
    x, aux = checkpoint(lambda x_: block(lp, x_, m, r, mm), x,
                        use_reentrant=False)
    return x, aux


def loss_of(params, batch, m, cut: dict, precision: str = "float32",
            decision=None, on_cut_grad=None):
    """(loss, the cut (B, S, d), the quantizer's (codebooks, codes)).
    ``decision`` takes the quantizer's codebooks and codes as given;
    ``on_cut_grad`` is called with the gradient arriving at z̃ (B, S, d)
    in the backward pass."""
    r, mm = lowprec.rounder(precision), lowprec.product(precision)
    z, aux_c = client_cut(params, batch["tokens"], m, r, mm)
    b, s, d = z.shape
    q = d // cut["subvector_dim"]
    if decision is None:
        zt, codes, cents = pq.quantize(z, q, cut["clusters"], cut["iters"])
        decision = (cents, codes)
    else:
        cents, codes = decision
        zt = pq.from_groups(pq.gather(cents.float(), codes.long()), b, s, d,
                            q)
    x = pq.Corrected.apply(z, zt, cut["lam"])
    if on_cut_grad is not None:
        x.register_hook(on_cut_grad)
    lp = layer_params(params, "server")
    x, aux_s = checkpoint(lambda x_: block(lp, x_, m, r, mm), x,
                          use_reentrant=False)
    x = rms_norm(x, params["server/final_norm/scale"], m["norm_eps"])
    labels = batch["labels"]
    ce = ce_sum(x, params["server/head"], labels, mm) \
        / (labels >= 0).sum().clamp_min(1)
    return ce + aux_c + aux_s, z.detach(), decision
