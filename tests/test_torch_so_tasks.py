"""Parity of the port's SO Tag and SO NWP tasks with the JAX package's, on
the CPU at small widths: the generators (``repro_torch/data/synthetic``),
the models (``SOTagMLP``, ``SONwpLSTM``) and their cut
(``_maybe_quantize`` on a 2-D and a 3-D cut), ``FederatedTrainer`` over
three rounds of each task, and the routes the clustering kernels take at
large codebooks.

Both packages start from the same weights (``from_jax_params``). Inputs
come from numpy seeds; the reference's tag batches come from
``jax.random`` and are handed to the port, while its LM batches are numpy
and the port draws them itself, bitwise. Tolerances: losses, metrics and
z̃ to f32 noise (rtol 1e-5 for one step, 1e-4 over a trainer run, where
sums run in another order and Lloyd's centroids drift by f32 rounding);
codes, counts, wire bytes and the generators' outputs bitwise.
"""

import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantizer import PQConfig as JPQConfig
from repro.data.synthetic import make_federated_lm_data as j_lm_data
from repro.data.synthetic import make_federated_tag_data as j_tag_data
from repro.federated import FederatedTrainer as JTrainer
from repro.kernels import ref as jref
from repro.models import paper_models as jpm
from repro.optim import adagrad as jadagrad
from repro.optim import adam as jadam
from repro_torch.core.quantizer import PQConfig
from repro_torch.data.synthetic import (make_federated_lm_data,
                                        make_federated_tag_data,
                                        make_lm_batch)
from repro_torch.federated import FederatedTrainer
from repro_torch.kernels import lloyd_update as tlu
from repro_torch.kernels.kmeans_assign import assign_route
from repro_torch.kernels.lloyd_update import (TILE_L, Layout, lloyd_layout,
                                              lloyd_update_in_kernel_order,
                                              row_route)
from repro_torch.kernels.pq_quantize import pq_route
from repro_torch.models import paper_models as tpm
from repro_torch.optim import adagrad, adam

CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
RUN_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _full_f32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _seed_of(key) -> int:
    """The reference LM generator's seed for a key (its ``_seed_of``)."""
    return int(np.asarray(jax.random.key_data(key)).astype(np.uint64)[-1])


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _nonlocals(fn):
    return inspect.getclosurevars(fn).nonlocals


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cid,batch,seq", [(0, 4, 30), (5, 3, 7)])
def test_lm_batches_are_the_references_bitwise(cid, batch, seq):
    """A batch drawn from default_rng(_seed_of(key)) is the reference's
    batch for that key, token for token; so is the eval batch."""
    jd = j_lm_data(num_clients=8, vocab=300, seed=3)
    td = make_federated_lm_data(num_clients=8, vocab=300, seed=3,
                                device=CPU)
    np.testing.assert_array_equal(td.client_weights, jd.client_weights)
    key = jax.random.fold_in(jax.random.PRNGKey(7), cid)
    jb = jd.sample_batch(cid, key, batch, seq=seq)
    tb = td.sample_batch(cid, np.random.default_rng(_seed_of(key)), batch,
                         seq=seq)
    for k in ("tokens", "labels"):
        assert tb[k].dtype == torch.int64 and tb[k].shape == (batch, seq)
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    je = jd.eval_batch(key, batch, seq=seq)
    te = td.eval_batch(np.random.default_rng(_seed_of(key)), batch, seq=seq)
    np.testing.assert_array_equal(te["tokens"].numpy(),
                                  np.asarray(je["tokens"]))


def test_tag_tables_are_the_references_bitwise():
    """Topic words, topic tags, client mixtures and weights: the same
    numpy draws in the same order."""
    jd = j_tag_data(num_clients=8, bow_dim=50, num_tags=30, seed=4)
    td = make_federated_tag_data(num_clients=8, bow_dim=50, num_tags=30,
                                 seed=4, device=CPU)
    np.testing.assert_array_equal(td.client_weights, jd.client_weights)
    jgen, tgen = (_nonlocals(d.sample_batch)["_gen"] for d in (jd, td))
    for jk, tk in (("tw", "tw"), ("tt", "tt")):
        np.testing.assert_array_equal(_nonlocals(tgen)[tk].numpy(),
                                      np.asarray(_nonlocals(jgen)[jk]))
    # the mixtures are f64 draws; the reference holds them in f32
    np.testing.assert_array_equal(
        _nonlocals(td.sample_batch)["mix"].numpy().astype(np.float32),
        np.asarray(_nonlocals(jd.sample_batch)["mix_j"]))


def test_tag_batches_follow_the_references_law():
    """Shapes and dtypes; bags of words are relu(topic words + noise), so
    nonnegative; each example keeps at most its topic's 12 tags; the same
    Generator state gives the same batch."""
    td = make_federated_tag_data(num_clients=8, bow_dim=50, num_tags=30,
                                 seed=4, device=CPU)
    b = td.sample_batch(2, np.random.default_rng(1), 64)
    assert b["bow"].shape == (64, 50) and b["bow"].dtype == torch.float32
    assert b["tags"].shape == (64, 30) and (b["bow"] >= 0).all()
    assert set(torch.unique(b["tags"]).tolist()) <= {0.0, 1.0}
    assert int(b["tags"].sum(-1).max()) <= 12
    b2 = td.sample_batch(2, np.random.default_rng(1), 64)
    assert all(torch.equal(b[k], b2[k]) for k in b)
    e = td.eval_batch(np.random.default_rng(1), 5)
    assert e["bow"].shape == (5, 50)
    lm = make_lm_batch(np.random.default_rng(0), 3, 6, 11, device=CPU)
    assert lm["tokens"].shape == (3, 6) and int(lm["tokens"].max()) < 11
    assert torch.equal(lm["labels"][:, :-1], lm["tokens"][:, 1:])
    assert (lm["labels"][:, -1] == -1).all()


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _pq(q, l, backend):
    cls = JPQConfig if backend == "jnp" else PQConfig
    return cls(num_subvectors=q, num_clusters=l, kmeans_iters=4,
               backend=backend)


def _tag_pair(pq_args=None, client_batch=0, lam=1e-3):
    kw = dict(bow_dim=40, cut_dim=16, num_tags=12, lam=lam,
              client_batch=client_batch)
    jm = jpm.SOTagMLP(pq=pq_args and _pq(*pq_args, "jnp"), **kw)
    tm = tpm.SOTagMLP(pq=pq_args and _pq(*pq_args, "torch"), device=CPU,
                      **kw)
    params = jm.init(jax.random.PRNGKey(0))   # the run key
    tm.load_state_dict(tpm.from_jax_params(jax.tree.map(np.asarray,
                                                        params)))
    return jm, tm, params


def _nwp_pair(pq_args=None, client_batch=0, lam=1e-3, vocab=40):
    kw = dict(vocab=vocab, embed_dim=6, hidden=10, cut_dim=8, lam=lam,
              client_batch=client_batch)
    jm = jpm.SONwpLSTM(pq=pq_args and _pq(*pq_args, "jnp"), **kw)
    tm = tpm.SONwpLSTM(pq=pq_args and _pq(*pq_args, "torch"), device=CPU,
                       **kw)
    params = jm.init(jax.random.PRNGKey(0))   # the run key
    tm.load_state_dict(tpm.from_jax_params(jax.tree.map(np.asarray,
                                                        params)))
    return jm, tm, params


def _tag_batch(b, seed=5):
    r = np.random.default_rng(seed)
    bow = np.maximum(r.standard_normal((b, 40)), 0).astype(np.float32)
    tags = (r.random((b, 12)) < 0.2).astype(np.float32)
    return {"bow": bow, "tags": tags}


def _nwp_batch(b, s=6, vocab=40, seed=6):
    r = np.random.default_rng(seed)
    toks = r.integers(0, vocab, (b, s))
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1)], 1)
    labels[0, 2] = -1
    return {"tokens": toks, "labels": labels}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _loss_and_grads_match(jm, tm, params, batch, quantize):
    def jloss(p):
        return jm.loss(p, _jbatch(batch), quantize=quantize)

    (jl, jstats), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    tl, tstats = tm(_tbatch(batch), quantize=quantize)
    grads = torch.autograd.grad(tl, list(tm.parameters()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=RTOL)
    assert tstats.keys() == jstats.keys()
    for k in tstats:
        np.testing.assert_allclose(np.asarray(tstats[k], np.float64),
                                   np.asarray(jstats[k], np.float64),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for (name, _), g in zip(tm.named_parameters(), grads):
        part, leaf = name.split(".")
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[part][leaf]),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("pq_args,client_batch", [
    (None, 0), ((4, 5), 0), ((8, 3), 4)])
def test_sotag_loss_grads_and_recall_match_jax(pq_args, client_batch):
    jm, tm, params = _tag_pair(pq_args, client_batch)
    batch = _tag_batch(8)
    _loss_and_grads_match(jm, tm, params, batch, quantize=True)
    r5 = tm.recall_at_5(_tbatch(batch))
    np.testing.assert_allclose(float(r5), float(jm.recall_at_5(
        params, _jbatch(batch))), rtol=RTOL)


@pytest.mark.parametrize("pq_args,client_batch", [
    (None, 0), ((2, 6), 0), ((4, 3), 2)])
def test_sonwp_loss_grads_and_accuracy_match_jax(pq_args, client_batch):
    jm, tm, params = _nwp_pair(pq_args, client_batch)
    batch = _nwp_batch(4)
    _loss_and_grads_match(jm, tm, params, batch, quantize=True)
    acc = tm.accuracy(_tbatch(batch))
    np.testing.assert_allclose(float(acc), float(jm.accuracy(
        params, _jbatch(batch))), rtol=RTOL)
    # the cut is (B, S, d): one d-vector per position
    assert tm.client_forward(_tbatch(batch)["tokens"]).shape == (4, 6, 8)


def test_models_take_their_cut_input_under_input_key():
    assert (tpm.FemnistCNN.input_key, tpm.SOTagMLP.input_key,
            tpm.SONwpLSTM.input_key) == ("image", "bow", "tokens")


@pytest.mark.parametrize("client_batch", [0, 2])
@pytest.mark.parametrize("shape", [(6, 16), (6, 5, 16)])
def test_maybe_quantize_matches_jax_on_2d_and_3d_cuts(shape, client_batch):
    """z̃ to f32 noise; the distortion and the compression ratio over all
    n = x.size / d vectors as the reference reports them."""
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    jz, js = jpm._maybe_quantize(jnp.asarray(x), _pq(4, 3, "jnp"), 1e-3,
                                 True, client_batch)
    tz, ts = tpm._maybe_quantize(torch.from_numpy(x), _pq(4, 3, "torch"),
                                 1e-3, True, client_batch)
    assert tz.shape == shape
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(ts["pq_distortion"]),
                               float(js["pq_distortion"]), rtol=RTOL)
    assert ts["pq_compression_ratio"] == js["pq_compression_ratio"]


# ---------------------------------------------------------------------------
# FederatedTrainer, three rounds of each task, L = 96
# ---------------------------------------------------------------------------

def _run_pair(task, **cut_kw):
    """(reference history, port history, reference trainer, port trainer)
    of 3 rounds at L = 96 (above the generic routes' threshold; the plain
    versions and the reference's jnp backend take any L); ``cut_kw``
    (warm_start, error_feedback) goes to both trainers."""
    key = jax.random.PRNGKey(0)
    if task == "tag":
        cb, cohort = 32, 3
        jdata = j_tag_data(num_clients=6, bow_dim=40, num_tags=12, seed=1)
        tdata = make_federated_tag_data(num_clients=6, bow_dim=40,
                                        num_tags=12, seed=1, device=CPU)
        jm, tm, params = _tag_pair((8, 96), cb)       # D = 2, N = 256
        jopt, topt, kw = jadagrad(10 ** -0.5), adagrad(10 ** -0.5), {}
    else:
        cb, cohort = 4, 3
        jdata = j_lm_data(num_clients=6, vocab=40, seed=1)
        tdata = make_federated_lm_data(num_clients=6, vocab=40, seed=1,
                                       device=CPU)
        jm, tm, params = _nwp_pair((2, 96), cb)       # D = 4, N = 240
        jopt, topt, kw = jadam(0.01), adam(0.01), {"batch_kwargs":
                                                   {"seq": 30}}
    kw.update(cut_kw)
    jt = JTrainer(jm, jopt, jdata, cohort=cohort, client_batch=cb, **kw)
    tt = FederatedTrainer(tm, topt, tdata, cohort=cohort, client_batch=cb,
                          device=CPU, **kw)

    def round_key(round_id, cid, draw):
        if round_id == 0:    # the wire measurement's batches
            k = jax.random.fold_in(key, 0)
            return jax.random.fold_in(k, 1) if draw else k
        return jax.random.fold_in(jax.random.fold_in(key, round_id), cid)

    def batch_for(cid, round_id, draw=0):
        k = round_key(round_id, cid, draw)
        if task == "nwp":    # numpy in both packages: drawn by the port
            return tdata.sample_batch(
                int(cid), np.random.default_rng(_seed_of(k)), cb, seq=30)
        b = jdata.sample_batch(int(cid), k, cb)
        return {n: torch.from_numpy(np.array(v)) for n, v in b.items()}

    tt.client_batch_for = batch_for
    _, jhist = jt.run(3, key)
    state, thist = tt.run(3, 0)
    return jhist, thist, jt, tt


@pytest.mark.parametrize("task,cut_kw", [
    ("tag", {}), ("nwp", {}),
    # the (B, S, d) cut's per-client EF memory and warm codebooks, carried
    # across rounds by client id
    ("nwp", {"warm_start": True, "error_feedback": True})])
def test_trainer_three_rounds_match_jax(task, cut_kw):
    jhist, thist, jt, tt = _run_pair(task, **cut_kw)
    assert len(thist) == len(jhist) == 3
    for a, b in zip(thist, jhist):
        for k in ("loss", "pq_compression_ratio"):
            np.testing.assert_allclose(a[k], b[k], rtol=RUN_RTOL,
                                       err_msg=k)
        # a near-exact cover (the tag cut after AdaGrad's first large
        # step) leaves a distortion of f32 rounding, ~1e-8: held to 1e-7
        np.testing.assert_allclose(a["pq_distortion"], b["pq_distortion"],
                                   rtol=RUN_RTOL, atol=1e-7)
    for a, b in zip(tt.last_trace, jt.last_trace):
        assert (a.uplink_bytes, a.downlink_bytes, a.participants) \
            == (b.uplink_bytes, b.downlink_bytes, b.participants)
    if cut_kw:
        assert tt._ef_memory.keys() == jt._ef_memory.keys()
        for c, mem in tt._ef_memory.items():
            assert mem.shape == (4, 30, 8)
            np.testing.assert_allclose(mem.numpy(),
                                       np.asarray(jt._ef_memory[c]),
                                       rtol=RUN_RTOL, atol=1e-6)
        assert tt._client_q.keys() == jt._client_q.keys()


# ---------------------------------------------------------------------------
# the clustering kernels' routes at large L
# ---------------------------------------------------------------------------

H100_GENERIC_MAX_L = 89   # lloyd_update_generic_max_l on an H100


def test_tiled_route_threshold_and_choice(monkeypatch):
    """lloyd_update takes the tiled route above the card's threshold
    (``generic_max_l``, which the library works out on the card: an H100's
    answer stands in for it here), the generic one at and below it, and
    the generic one up to ``TILE_L`` without asking the card (a mask does
    not change the route); pq_quantize and kmeans_assign take their generic
    route at any L; d8 keeps its shapes. TILE_L is the CUDA sources'
    tile of centroids."""
    src = (Path(tlu.__file__).parents[1] / "csrc" / "assign.cuh").read_text()
    assert re.search(r"constexpr int kLTile = (\d+);", src)[1] == str(TILE_L)
    asked = []

    def card(device):
        asked.append(device)
        return H100_GENERIC_MAX_L
    monkeypatch.setattr(tlu, "generic_max_l", card)
    x8, x16 = torch.zeros(2, 64, 8), torch.zeros(2, 64, 16)
    for l in (H100_GENERIC_MAX_L + 1, 100, 960, 2048):
        assert row_route(x16, l) == row_route(x8, l) == "tiled"
        lay = lloyd_layout(torch.zeros(3, 2500, 32), l)
        assert lay == Layout("tiled", 1024, 3)
    for l in (TILE_L + 1, H100_GENERIC_MAX_L):
        assert row_route(x16, l) == "generic"
    assert asked and all(d == CPU for d in asked)
    asked.clear()
    for l in (3, 30, 60, TILE_L):
        assert row_route(x16, l) == "generic"
    assert not asked
    for l in (3, TILE_L, H100_GENERIC_MAX_L + 1, 960, 2048):
        assert pq_route(x16, l) == assign_route(x16, l, None) == "generic"
        assert pq_route(x8, l) == assign_route(x8, l, torch.ones(l)) \
            == "generic"
    assert row_route(x8, 16) == pq_route(x8, 16) \
        == assign_route(x8, 16, None) == "d8"
    assert row_route(x8, 2) == "d8"
    assert lloyd_layout(x16, 100).route == "tiled"


def _block_order_by_hand(x, w, c, rows):
    """The generic and tiled routes' sums one f32 addition at a time:
    block b adds rows b·rows .. (b+1)·rows − 1 in row order into its
    code's sums, then the blocks add in block order."""
    f32 = np.float32
    p, n, d = x.shape
    l = c.shape[1]
    scores = 2 * np.einsum("pnd,pld->pnl", x.astype(np.float64),
                           c.astype(np.float64)) - (c.astype(np.float64)
                                                    ** 2).sum(-1)[:, None]
    codes = scores.argmax(-1)
    out = np.zeros((p, l, d + 1), f32)
    for q in range(p):
        total = np.zeros((l, d + 1), f32)
        for b0 in range(0, n, rows):
            part = np.zeros((l, d + 1), f32)
            for i in range(b0, min(b0 + rows, n)):
                k = codes[q, i]
                part[k, :d] = part[k, :d] + w[q, i] * (x[q, i] - c[q, k])
                part[k, d] = part[k, d] + w[q, i]
            total = total + part
        out[q] = total
    return out[..., :d], out[..., d]


@pytest.mark.parametrize("n", [300, 60])
@pytest.mark.parametrize("route", ["generic", "tiled"])
def test_block_order_is_the_by_hand_order(route, n):
    """lloyd_update_in_kernel_order on the generic and tiled layouts is
    bitwise the additions written out; with L = 150 > N / 2 (and N < L),
    many clusters are empty and keep exact zeros."""
    r = np.random.default_rng(9)
    x = r.standard_normal((2, n, 4)).astype(np.float32)
    c = r.standard_normal((2, 150, 4)).astype(np.float32)
    w = (r.random((2, n)) < 0.9).astype(np.float32)
    ds_h, ct_h = _block_order_by_hand(x, w, c, 128)
    ds, ct = lloyd_update_in_kernel_order(_t(x), _t(w), _t(c), None,
                                          Layout(route, 128, -(-n // 128)))
    np.testing.assert_array_equal(ds.numpy(), ds_h)
    np.testing.assert_array_equal(ct.numpy(), ct_h)
    assert (ct == 0).any()
    for p in range(2):
        ds_r, ct_r = jref.lloyd_update_ref(
            jnp.asarray(x[p]), jnp.asarray(w[p]), jnp.asarray(c[p]),
            jnp.ones(150))
        np.testing.assert_array_equal(ct[p].numpy(), np.asarray(ct_r))
        np.testing.assert_allclose(ds[p].numpy(), np.asarray(ds_r),
                                   rtol=1e-5, atol=1e-5)
