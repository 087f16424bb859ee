"""The split Granite-4.0-H hybrid's training step, plainly, in f32
(ibm-granite/granite-4.0-h-small's config.json, with the cut, the routing
and the expert share of the configuration's file).

    x = embed(ids) · embedding_multiplier                 (the tied table)
    each layer:  h = x + r · mixer(RMSNorm(x))            (r: residual_multiplier)
                 x = h + r · (MoE(RMSNorm(h)) + Shared(RMSNorm(h)))
    logits = RMSNorm(x) · Eᵀ / logits_scaling

The mixer is the period's (``layer_pattern``): a Mamba-2 block or NoPE
GQA attention. Mamba-2 (one B/C group): z, x, BC and dt projections (no
bias); depthwise causal convolutions (with a bias) of x and of BC, each
through SiLU; dt = softplus(dt + dt_bias), A = −exp(A_log); the SSD
computed here in its quadratic ("masked attention") form,

    y = (L ∘ C·Bᵀ)·(x·dt) + D·x,   L[i, j] = exp(Σ_{j<t≤i} dt_t·A)  (j ≤ i),

in blocks of heads and query rows, independently of the program's
chunked scan; then y·SiLU(z), an RMSNorm over d_inner and the out
projection. Attention: GQA (query head h reads key/value head
h // (H / Kv)), no rotary, the scores times ``attention_multiplier``,
causal, softmax in f32. MoE: an f32 router, softmax over all
``num_experts``, the top k (the lower index first on a tie), their
weights renormalized (which is softmax over the top-k logits, as the
published model takes it); each expert takes at most C = max(8,
ceil8(ceil(k·N/E·capacity))) (token, choice) pairs, ranked in token-major
order over all E experts; only the pairs routed to the experts held here
(``experts_held`` from ``first_expert_held``) are computed, and each is a
SwiGLU (silu(x·Wg) ⊙ (x·Wu))·Wd; the Switch balance loss E·Σ_e mean p_e ·
mean chosen_e over all E, times its weight. The shared expert is a SwiGLU
on the same normed input. The client holds the embedding and the first
``cut_periods`` periods; each sequence is one client, and its cut goes
through FedLite's grouped PQ with the eq.-5 corrected backward. The
server holds the other periods and the final norm; the head is the
client's embedding table. The loss is the mean CE over the labels that
are not −1 plus both sides' balance losses.

Departures from the published description: the expert capacity (the
published model routes without one; the port has no dropless MoE), and
the expert share (the experts not held here add nothing, in the program
and here alike), both as the configuration's file states.

Params are a flat dict keyed by '/'-joined paths (the positions of a
period stacked on a leading axis of one period each), as ``param_specs``
lists them. Each layer is rematerialized in the backward pass, and
within it the Mamba block's parts, the attention's blocks of query rows,
the SSD's blocks of heads and query rows and the CE's blocks of
positions, so the f32 step of the full widths fits one card. The products' inputs go through
``lowprec`` (a weight's product through ``lowprec.product``); the router
and the decay stay in f32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fedbench.reference import lowprec, pq

Q_BLOCK = 256          # attention query rows a block
SSD_ROWS = 512         # SSD query rows a block
SSD_HEADS = 4          # SSD heads a block
CE_BLOCK = 512


def held(m: dict) -> int:
    return m.get("experts_held") or m["num_experts"]


def param_specs(m: dict) -> Dict[str, tuple]:
    """{key: (shape, dtype name)} of the params, from the config's
    ``model``."""
    d, hd, f = m["d_model"], m["head_dim"], m["d_ff"]
    q, kv = m["num_heads"] * hd, m["num_kv_heads"] * hd
    din = m["ssm_expand"] * d
    n, w = m["ssm_state"], m["ssm_conv_width"]
    heads = din // m["ssm_head_dim"]
    fs, e = m["shared_d_ff"], held(m)
    v = -(-m["vocab_size"] // m["vocab_pad_to"]) * m["vocab_pad_to"]
    pdt, f32 = m["param_dtype"], "float32"
    pattern = m["layer_pattern"]
    if m["num_layers"] % len(pattern) or not m["tie_embeddings"]:
        raise ValueError("the reference lays out whole periods and a tied "
                         "head")
    periods = m["num_layers"] // len(pattern)

    def stack(n_periods, side):
        out = {}
        for j, kind in enumerate(pattern):
            pre = f"{side}/layers/p{j}"

            def put(name, shape, dt=pdt):
                out[f"{pre}/{name}"] = ((n_periods, *shape), dt)
            put("ln1/scale", (d,))
            put("ln2/scale", (d,))
            if kind == "attn":
                put("mixer/wq", (d, q))
                put("mixer/wk", (d, kv))
                put("mixer/wv", (d, kv))
                put("mixer/wo", (q, d))
            else:
                put("mixer/in_proj_z", (d, din))
                put("mixer/in_proj_x", (d, din))
                put("mixer/in_proj_bc", (d, 2 * n))
                put("mixer/in_proj_dt", (d, heads))
                put("mixer/out_proj", (din, d))
                put("mixer/conv_w", (w, din))
                put("mixer/conv_b", (din,))
                put("mixer/conv_w_bc", (w, 2 * n))
                put("mixer/conv_b_bc", (2 * n,))
                put("mixer/A_log", (heads,), f32)
                put("mixer/ssm_D", (heads,), f32)
                put("mixer/dt_bias", (heads,), f32)
                put("mixer/gate_norm/scale", (din,))
            put("ffn/router", (d, m["num_experts"]), f32)
            put("ffn/we_gate", (e, d, f))
            put("ffn/we_up", (e, d, f))
            put("ffn/we_down", (e, f, d))
            put("shared/w_gate", (d, fs))
            put("shared/w_up", (d, fs))
            put("shared/w_down", (fs, d))
        return out
    return {"client/tok_embed": ((v, d), pdt),
            **stack(m["cut_periods"], "client"),
            **stack(periods - m["cut_periods"], "server"),
            "server/final_norm/scale": ((d,), pdt)}


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def causal_conv(x, w, b):
    """Depthwise causal convolution: x (B, S, C), taps w (W, C); output
    t sums x[t − W + 1 + i]·w[i]."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    return sum(xp[:, i:i + s] * w[i] for i in range(width)) + b


def ssd(x, dt, a, bm, cm, r):
    """The quadratic SSD: x (B, S, H, P), dt (B, S, H), a (H,), bm / cm
    (B, S, N) -> y (B, S, H, P) with no D term. The decay's cumulative sum
    is taken in f64 and each row block's exponents relative to its first
    row, so the differences near the diagonal keep f32's precision."""
    b, s, h, p = x.shape
    cum = (dt.double() * a.double()).cumsum(1)              # (B, S, H)
    xdt = r(x * dt[..., None])
    bm, cm = r(bm), r(cm)
    pos = torch.arange(s, device=x.device)

    def block(i0, cm_i, bm_j, xdt_j, cum_h):
        i1 = i0 + cm_i.shape[1]
        ref = cum_h[:, i0:i0 + 1]
        ci = (cum_h[:, i0:i1] - ref).float()
        cj = (cum_h[:, :i1] - ref).float()
        diff = ci.transpose(1, 2)[..., :, None] \
            - cj.transpose(1, 2)[..., None, :]              # (B, h, rows, i1)
        keep = pos[i0:i1, None] >= pos[None, :i1]
        lmat = torch.exp(torch.where(keep, diff, -math.inf))
        scores = r(lmat * (cm_i @ bm_j.transpose(1, 2))[:, None])
        return torch.einsum("bhij,bjhp->bihp", scores, xdt_j)

    # heads split first, so a block's slices are of its heads' tensors
    heads = zip(xdt.split(SSD_HEADS, 2), cum.split(SSD_HEADS, 2))
    out = []
    for xdt_h, cum_h in heads:
        out.append(torch.cat([
            checkpoint(block, i0, cm[:, i0:i0 + SSD_ROWS],
                       bm[:, :i0 + SSD_ROWS], xdt_h[:, :i0 + SSD_ROWS],
                       cum_h, use_reentrant=False)
            for i0 in range(0, s, SSD_ROWS)], 1))
    return torch.cat(out, 2)


def mamba(p, x, m, r, mm):
    """The Mamba-2 block in three parts, each rematerialized in the
    backward pass: the projections and convolutions, the SSD, the gate,
    its norm and the out projection."""
    b, s, _ = x.shape
    n, hp = m["ssm_state"], m["ssm_head_dim"]

    def inputs(x):
        xc = F.silu(causal_conv(mm(x, p["in_proj_x"]), p["conv_w"],
                                p["conv_b"]))
        bc = F.silu(causal_conv(mm(x, p["in_proj_bc"]), p["conv_w_bc"],
                                p["conv_b_bc"]))
        dt = F.softplus(mm(x, p["in_proj_dt"]) + p["dt_bias"])
        return xc.reshape(b, s, -1, hp), dt, bc[..., :n], bc[..., n:]

    def output(y, x):
        y = y.reshape(b, s, -1) * F.silu(mm(x, p["in_proj_z"]))
        y = rms_norm(y, p["gate_norm/scale"], m["norm_eps"])
        return mm(y, p["out_proj"])

    xh, dt, bm, cm = checkpoint(inputs, x, use_reentrant=False)
    y = ssd(xh, dt, -torch.exp(p["A_log"]), bm, cm, r) \
        + p["ssm_D"][:, None] * xh
    return checkpoint(output, y, x, use_reentrant=False)


def attention(p, x, m, r, mm):
    b, s, _ = x.shape
    h, kv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    g = h // kv
    scale = m.get("attention_multiplier") or 1.0 / math.sqrt(hd)
    qg = r(mm(x, p["wq"]).reshape(b, s, kv, g, hd))
    k = r(mm(x, p["wk"]).reshape(b, s, kv, hd))
    v = r(mm(x, p["wv"]).reshape(b, s, kv, hd))
    pos = torch.arange(s, device=x.device)

    def block(i, qb):
        sc = torch.einsum("bqkgh,bskh->bkgqs", qb, k) * scale
        keep = pos[i:i + Q_BLOCK, None] >= pos[None, :]
        pr = torch.softmax(sc.masked_fill(~keep, float("-inf")), -1)
        return torch.einsum("bkgqs,bskh->bqkgh", r(pr), v)
    o = torch.cat([checkpoint(block, i, qg[:, i:i + Q_BLOCK],
                              use_reentrant=False)
                   for i in range(0, s, Q_BLOCK)], 1).reshape(b, s, h * hd)
    return mm(o, p["wo"])


def capacity(m: dict, tokens: int) -> int:
    c = int(math.ceil(m["experts_per_token"] * tokens / m["num_experts"]
                      * m["capacity_factor"]))
    return max(8, -(-c // 8) * 8)


def swiglu(x, wg, wu, wd, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def moe(p, x, m, mm):
    """(the held experts' part of the layer's output, balance loss)."""
    b, s, d = x.shape
    e, k = m["num_experts"], m["experts_per_token"]
    first = m.get("first_expert_held", 0)
    xf = x.reshape(b * s, d)
    probs = torch.softmax(xf @ p["router"], -1)
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
    for j in range(held(m)):
        pairs = torch.nonzero((flat == first + j) & kept)[:, 0]
        if not len(pairs):      # an expert no pair reached adds nothing
            continue
        tok = pairs // k
        ye = swiglu(xf[tok], p["we_gate"][j], p["we_up"][j],
                    p["we_down"][j], mm)
        y = y.index_add(0, tok, ye * w[tok, pairs % k][:, None])
    chosen = F.one_hot(idx, e).float().sum(1)
    aux = e * (probs.mean(0) * chosen.mean(0)).sum() * m["router_aux_weight"]
    return y.reshape(b, s, d), aux


def layer(p, x, kind, m, r, mm):
    """One layer (``p``: its leaves, named from the position on)."""
    eps, rm = m["norm_eps"], m["residual_multiplier"]
    sub = {k.split("/", 1)[1]: v for k, v in p.items()
           if k.startswith("mixer/")}
    mixer = attention if kind == "attn" else mamba
    x = x + rm * mixer(sub, rms_norm(x, p["ln1/scale"], eps), m, r, mm)
    hn = rms_norm(x, p["ln2/scale"], eps)
    y, aux = moe({k[4:]: v for k, v in p.items() if k.startswith("ffn/")},
                 hn, m, mm)
    y = y + swiglu(hn, p["shared/w_gate"], p["shared/w_up"],
                   p["shared/w_down"], mm)
    return x + rm * y, aux


def run_side(params, side, x, m, r, mm):
    """The side's layers, each rematerialized in the backward pass as one
    node (a reentrant checkpoint), whose recomputation waits for the
    gradients of both its outputs, the residual and the balance loss: one
    layer's internals are alive at a time. (As a region of ops, each
    layer would be recomputed as soon as its balance loss's gradient
    came, at the start of the backward pass, and all of them held.)
    Returns (x, the summed balance loss)."""
    pattern = m["layer_pattern"]
    pre = f"{side}/layers/"
    aux = x.new_zeros(())
    for i in range(params[f"{pre}p0/ln1/scale"].shape[0]):
        for j, kind in enumerate(pattern):
            lp = {k[len(f"{pre}p{j}/"):]: v[i] for k, v in params.items()
                  if k.startswith(f"{pre}p{j}/")}
            if torch.is_grad_enabled():
                x, a = checkpoint(lambda x_, lp=lp, kind=kind: layer(
                    lp, x_, kind, m, r, mm), x, use_reentrant=True)
            else:
                x, a = layer(lp, x, kind, m, r, mm)
            aux = aux + a
    return x, aux


def ce_sum(x, head, labels, scaling, mm):
    def body(xb, lb):
        logits = mm(xb, head) / scaling
        lse = torch.logsumexp(logits, -1)
        got = logits.gather(-1, lb.clamp_min(0)[..., None])[..., 0]
        return ((lse - got) * (lb >= 0)).sum()
    tot = x.new_zeros(())
    for i in range(0, x.shape[1], CE_BLOCK):
        tot = tot + checkpoint(body, x[:, i:i + CE_BLOCK],
                               labels[:, i:i + CE_BLOCK], use_reentrant=False)
    return tot


def logits_of(params, tokens, m):
    """The full forward's f32 logits (B, S, vocab_size), with no cut: what
    serving's prefill and decode steps are held to."""
    r, mm = lowprec.rounder("float32"), lowprec.product("float32")
    table = params["client/tok_embed"]
    x = F.embedding(tokens, table) * m["embedding_multiplier"]
    x, _ = run_side(params, "client", x, m, r, mm)
    x, _ = run_side(params, "server", x, m, r, mm)
    x = rms_norm(x, params["server/final_norm/scale"], m["norm_eps"])
    return x @ table[:m["vocab_size"]].t() / m["logits_scaling"]


def loss_of(params, batch, m, cut: dict, precision: str = "float32",
            decision=None, on_cut_grad=None):
    """(loss, the cut (B, S, d), the quantizer's (codebooks, codes)).
    ``decision`` takes the quantizer's codebooks and codes as given;
    ``on_cut_grad`` is called with the gradient arriving at z̃ (B, S, d)
    in the backward pass."""
    r, mm = lowprec.rounder(precision), lowprec.product(precision)
    table = params["client/tok_embed"]
    x = F.embedding(batch["tokens"], table) * m["embedding_multiplier"]
    z, aux_c = run_side(params, "client", x, m, r, mm)
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
    x, aux_s = run_side(params, "server", x, m, r, mm)
    x = rms_norm(x, params["server/final_norm/scale"], m["norm_eps"])
    labels = batch["labels"]
    head = table[:m["vocab_size"]].t()
    ce = ce_sum(x, head, labels, m["logits_scaling"], mm) \
        / (labels >= 0).sum().clamp_min(1)
    return ce + aux_c + aux_s, z.detach(), decision
