"""The port's NerrfNet (nerrf_tpu_torch.models) against the JAX package's,
on the same windows with converted weights.

Flax params from ``NerrfNet.init`` go through ``nerrf_tpu_torch.convert``;
inputs are real window samples of a small simulated attack trace, lowered by
the JAX package.  Tolerances:

* float32: atol = rtol = 1e-4 on logits (measured max |Δ| about 1.3e-6:
  the same arithmetic, summed in another order);
* bfloat16: atol 0.1 (measured max |Δ| about 0.035 on logits of magnitude
  ≤ 2 — bf16 keeps 8 bits, and XLA and PyTorch round at different points
  of the same ops, e.g. elementwise chains XLA rounds per op);
* loss gradients (float32, dropout 0): per parameter, ‖Δg‖ ≤ 1e-4·‖g‖ +
  1e-7 (measured at most 8.6e-7 relative: the same adjoints, summed
  in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from nerrf_tpu.data import SimConfig, simulate_trace
from nerrf_tpu.graph import GraphConfig
from nerrf_tpu.models.graphsage import GraphSAGEConfig as JGraphSAGEConfig
from nerrf_tpu.models.joint import JointConfig as JJointConfig
from nerrf_tpu.models.joint import NerrfNet as JNerrfNet
from nerrf_tpu.models.lstm import ImpactLSTM as JImpactLSTM
from nerrf_tpu.models.lstm import LSTMConfig as JLSTMConfig
from nerrf_tpu.train.data import DatasetConfig, windows_of_trace
from nerrf_tpu.train.loop import TrainConfig as JTrainConfig
from nerrf_tpu.train.loop import make_loss_fn as j_make_loss_fn
from nerrf_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params, lstm_state_dict)
from nerrf_tpu_torch.models import (
    GraphSAGEConfig, ImpactLSTM, JointConfig, LSTMConfig, NerrfNet,
    build_nerrfnet)
from nerrf_tpu_torch.models.layers import LayerNorm, gelu
from nerrf_tpu_torch.pipeline import MODEL_INPUTS
from nerrf_tpu_torch.train.loop import TrainConfig, make_loss_fn

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL = 0.1
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7
TRAIN_KEYS = MODEL_INPUTS + ("edge_label", "node_label", "seq_label",
                             "seq_valid")
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _windows(keys):
    tr = simulate_trace(SimConfig(duration_sec=60.0, attack=True,
                                  attack_start_sec=20.0, num_target_files=4,
                                  benign_rate_hz=20.0, seed=2))
    samples = windows_of_trace(tr, DatasetConfig(
        graph=GraphConfig(window_sec=45.0, stride_sec=20.0,
                          max_nodes=64, max_edges=128),
        seq_len=24, max_seqs=32))
    assert len(samples) >= 2
    return {k: np.stack([s[k] for s in samples]) for k in keys}


@pytest.fixture(scope="module")
def batch():
    return _windows(MODEL_INPUTS)


@pytest.fixture(scope="module")
def train_batch():
    """The same windows with the labels and masks the loss reads."""
    return _windows(TRAIN_KEYS)


def _configs(mode, dtype, lstm_layers=None):
    jdt, tdt = _DT[dtype]
    jc, tc = JJointConfig().small, JointConfig().small
    jc = dataclasses.replace(
        jc, gnn=dataclasses.replace(jc.gnn, dtype=jdt, aggregation=mode),
        lstm=dataclasses.replace(jc.lstm, dtype=jdt))
    tc = dataclasses.replace(
        tc, gnn=dataclasses.replace(tc.gnn, dtype=tdt, aggregation=mode),
        lstm=dataclasses.replace(tc.lstm, dtype=tdt))
    if lstm_layers:
        jc = dataclasses.replace(jc, lstm=dataclasses.replace(
            jc.lstm, num_layers=lstm_layers))
        tc = dataclasses.replace(tc, lstm=dataclasses.replace(
            tc.lstm, num_layers=lstm_layers))
    return jc, tc


def _init(jcfg, batch, seed=0):
    first = tuple(jnp.asarray(batch[k][0]) for k in MODEL_INPUTS)
    return jax.jit(JNerrfNet(jcfg).init)(jax.random.PRNGKey(seed),
                                         *first)["params"]


@pytest.fixture(scope="module")
def small_params(batch):
    """One init serves every aggregation mode and compute type: the param
    tree is float32 and the same for all of them."""
    return _init(_configs("fused", "float32")[0], batch)


def _run_both(jcfg, tcfg, batch, params=None):
    jm = JNerrfNet(jcfg)
    if params is None:
        params = _init(jcfg, batch)
    want = jax.jit(jax.vmap(lambda *a: jm.apply({"params": params}, *a)))(
        *[jnp.asarray(batch[k]) for k in MODEL_INPUTS])
    tm = load_flax_params(NerrfNet(tcfg), jax.device_get(params))
    with torch.inference_mode():
        got = tm(*[torch.from_numpy(batch[k]) for k in MODEL_INPUTS])
    return ({k: np.asarray(v, np.float32) for k, v in want.items()},
            {k: v.float().numpy() for k, v in got.items()})


@pytest.mark.parametrize("mode", ["fused", "dense_adj", "segment"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nerrfnet_matches_reference(batch, small_params, mode, dtype):
    want, got = _run_both(*_configs(mode, dtype), batch, small_params)
    for k in ("edge_logit", "node_logit", "seq_logit"):
        assert got[k].shape == want[k].shape
        if dtype == "float32":
            np.testing.assert_allclose(got[k], want[k], **F32_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=BF16_ATOL, err_msg=k)


def test_two_layer_lstm_matches_reference(batch):
    # the flagship's 2-layer BiLSTM: the per-layer merge_i and the
    # OptimizedLSTMCell_{2i+d} naming past layer 0
    want, got = _run_both(*_configs("fused", "float32", lstm_layers=2), batch)
    for k in ("seq_logit", "node_logit", "edge_logit"):
        np.testing.assert_allclose(got[k], want[k], **F32_TOL, err_msg=k)


def test_converter_covers_every_param(small_params):
    tc = _configs("fused", "float32")[1]
    params = jax.device_get(small_params)
    sd = flax_to_state_dict(params)
    tm = NerrfNet(tc)
    assert set(sd) == set(tm.state_dict())
    n_flax = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(params))
    n_lstm_bias_ih = sum(v.numel() for k, v in sd.items() if k.endswith("bias_ih"))
    assert sum(v.numel() for v in sd.values()) == n_flax + n_lstm_bias_ih
    # Dense kernels [in, out] arrive as Linear weights [out, in]
    np.testing.assert_array_equal(
        sd["gnn.node_enc.weight"].numpy(), np.asarray(params["gnn"]["node_enc"]["kernel"]).T)
    # gates stacked i, f, g, o with the bias on the recurrent side only
    cell = params["lstm"]["OptimizedLSTMCell_1"]    # layer 0, backward
    H = tc.lstm.hidden
    np.testing.assert_array_equal(sd["lstm.cells.1.weight_hh"][2 * H:3 * H].numpy(),
                                  np.asarray(cell["hg"]["kernel"]).T)
    np.testing.assert_array_equal(sd["lstm.cells.1.bias_hh"][H:2 * H].numpy(),
                                  np.asarray(cell["hf"]["bias"]))
    assert float(sd["lstm.cells.1.bias_ih"].abs().sum()) == 0.0


# --- the reference's traps, one test each -----------------------------------


def test_layernorm_eps_is_flax_1e6():
    # inputs whose variance is near eps: 1e-6 and PyTorch's default 1e-5
    # give visibly different outputs
    x = np.random.default_rng(0).normal(size=(6, 16)).astype(np.float32) * 3e-3
    params = {"scale": np.linspace(0.5, 1.5, 16).astype(np.float32),
              "bias": np.linspace(-0.2, 0.2, 16).astype(np.float32)}
    want = np.asarray(fnn.LayerNorm().apply({"params": params}, jnp.asarray(x)))
    ln = LayerNorm(16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(params["scale"]))
        ln.bias.copy_(torch.from_numpy(params["bias"]))
        got = ln(torch.from_numpy(x)).numpy()
        torch_default = torch.nn.functional.layer_norm(
            torch.from_numpy(x), (16,), ln.weight, ln.bias).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert np.max(np.abs(torch_default - want)) > 1e-2


def test_gelu_is_tanh_approximation():
    x = np.linspace(-5, 5, 401).astype(np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    got = gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(exact - want)) > 1e-4


def test_lstm_lengths_mask_padding():
    # left-padded ragged sequences (lengths 0, 1, 5 and full): outputs match
    # the reference, and whatever sits in the padding changes nothing
    rng = np.random.default_rng(7)
    S, T, F = 4, 9, 12
    lengths = np.array([0, 1, 5, T])
    mask = np.arange(T)[None, :] >= (T - lengths)[:, None]
    feat = rng.normal(size=(S, T, F)).astype(np.float32)
    jcfg = JLSTMConfig(hidden=16, num_layers=2, dtype=jnp.float32)
    jm = JImpactLSTM(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(feat),
                              jnp.asarray(mask))["params"]
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(feat),
                             jnp.asarray(mask))
    tm = ImpactLSTM(LSTMConfig(hidden=16, num_layers=2, dtype=torch.float32))
    tm.load_state_dict(lstm_state_dict(jax.device_get(params)), strict=True)
    noisy = feat + (~mask)[..., None] * rng.normal(size=feat.shape).astype(np.float32) * 50
    with torch.no_grad():
        got = tm(torch.from_numpy(feat), torch.from_numpy(mask))
        got_noisy = tm(torch.from_numpy(noisy), torch.from_numpy(mask))
    for k in ("seq_logit", "seq_emb"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), **F32_TOL)
        np.testing.assert_allclose(got_noisy[k].numpy(), got[k].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_fusion_routes_unmatched_sequences_to_dropped_slot(batch, small_params):
    # seq_node_idx = -1 routes a sequence to slot n, which is dropped: such a
    # sequence changes its own seq_logit but no node or edge output
    b = {k: v[:1].copy() for k, v in batch.items()}
    b["seq_node_idx"][0, :] = -1
    b["seq_node_idx"][0, 0] = int(np.nonzero(b["node_mask"][0])[0][0])
    want, got = _run_both(*_configs("fused", "float32"), b, small_params)
    for k in ("edge_logit", "node_logit", "seq_logit"):
        np.testing.assert_allclose(got[k], want[k], **F32_TOL, err_msg=k)
    jc, tc = _configs("fused", "float32")
    tm = build_nerrfnet(tc, seed=4, device="cpu")
    b2 = {k: v.copy() for k, v in b.items()}
    b2["seq_feat"][0, 1:] += 5.0          # every unmatched sequence
    with torch.inference_mode():
        o1 = tm(*[torch.from_numpy(b[k]) for k in MODEL_INPUTS])
        o2 = tm(*[torch.from_numpy(b2[k]) for k in MODEL_INPUTS])
    np.testing.assert_array_equal(o1["node_logit"].numpy(), o2["node_logit"].numpy())
    np.testing.assert_array_equal(o1["edge_logit"].numpy(), o2["edge_logit"].numpy())
    assert not np.array_equal(o1["seq_logit"].numpy(), o2["seq_logit"].numpy())


def test_init_draws_flax_kinds_from_generator():
    cfg = JointConfig().small
    a = build_nerrfnet(cfg, seed=11, device="cpu")
    b = build_nerrfnet(cfg, seed=11, device="cpu")
    c = build_nerrfnet(cfg, seed=12, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["gnn.node_enc.weight"], sc["gnn.node_enc.weight"])
    H = cfg.lstm.hidden
    w_hh = sa["lstm.cells.0.weight_hh"]
    for g in range(4):              # one orthogonal [H, H] block per gate
        blk = w_hh[g * H:(g + 1) * H]
        torch.testing.assert_close(blk @ blk.T, torch.eye(H), atol=1e-5, rtol=0)
    assert torch.equal(sa["gnn.final_ln.weight"], torch.ones(cfg.gnn.hidden))
    assert float(sa["gnn.blocks.0.dir_bias"].abs().sum()) == 0.0
    w = sa["gnn.blocks.0.w_msg.weight"]  # lecun_normal: var 1/fan_in, |x| ≤ 2σ
    assert abs(float(w.var()) * w.shape[1] - 1.0) < 0.25
    assert float(w.abs().max()) <= 2.0 / 0.8796 / w.shape[1] ** 0.5 + 1e-6


# --- training: gradients, the autograd repair, dropout ----------------------


def _no_dropout(jc, tc):
    jc = dataclasses.replace(
        jc, gnn=dataclasses.replace(jc.gnn, dropout=0.0),
        lstm=dataclasses.replace(jc.lstm, dropout=0.0))
    tc = dataclasses.replace(
        tc, gnn=dataclasses.replace(tc.gnn, dropout=0.0),
        lstm=dataclasses.replace(tc.lstm, dropout=0.0))
    return jc, tc


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("mode", ["segment", "fused"])
def test_loss_gradients_match_reference(train_batch, small_params, mode):
    # the port's loss and its gradient through every op's autograd Function
    # against jax.grad of the reference's make_loss_fn, compared by the
    # converter's names
    jc, tc = _no_dropout(*_configs(mode, "float32"))
    jloss = j_make_loss_fn(JNerrfNet(jc), JTrainConfig(model=jc))
    jb = {k: jnp.asarray(v) for k, v in train_batch.items()}
    (want_loss, _), jgrads = jax.value_and_grad(
        lambda p: jloss(p, jb, jax.random.PRNGKey(0)), has_aux=True)(small_params)
    want = flax_to_state_dict(jax.device_get(jgrads))
    tm = load_flax_params(NerrfNet(tc), jax.device_get(small_params))
    loss, _ = make_loss_fn(tm, TrainConfig(model=tc))(_torch_batch(train_batch))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, p in tm.named_parameters():
        g, w = p.grad.numpy(), want[name].numpy()
        err = np.linalg.norm(g - w)
        assert err <= GRAD_RTOL * np.linalg.norm(w) + GRAD_ATOL, (
            f"{name}: |Δg| {err} vs |g| {np.linalg.norm(w)}")


@pytest.mark.parametrize("mode", ["segment", "fused"])
def test_backward_reaches_every_parameter(train_batch, mode):
    # every op wrapper is an autograd Function: loss.backward() gives every
    # parameter of NerrfNet a gradient, at the flagship's compute type and
    # with dropout on
    tc = _configs(mode, "bfloat16")[1]
    tm = build_nerrfnet(tc, seed=5, device="cpu").train()
    loss, _ = make_loss_fn(tm, TrainConfig(model=tc))(
        _torch_batch(train_batch), torch.Generator().manual_seed(0))
    loss.backward()
    missing = [n for n, p in tm.named_parameters() if p.grad is None]
    assert not missing, missing
    zero = [n for n, p in tm.named_parameters()
            if not float(p.grad.abs().sum()) > 0]
    assert not zero, zero
    assert "lstm.cells.0.bias_ih" not in dict(tm.named_parameters())


def test_training_forward_dropout(batch):
    # flax's Dropout: keep with probability 1 - rate, scale by 1/(1 - rate),
    # masks from the generator alone; seq_emb is the pooled embedding after
    # dropout, the one the head (and the fusion) reads
    tc = _configs("fused", "float32")[1]
    tc = dataclasses.replace(
        tc, gnn=dataclasses.replace(tc.gnn, dropout=0.5),
        lstm=dataclasses.replace(tc.lstm, dropout=0.5))
    tm = build_nerrfnet(tc, seed=1, device="cpu")
    args = [torch.from_numpy(batch[k]) for k in MODEL_INPUTS]
    with torch.no_grad():
        o0 = tm(*args)
        o1 = tm(*args, dropout_gen=torch.Generator().manual_seed(7))
        o2 = tm(*args, dropout_gen=torch.Generator().manual_seed(7))
        head = tm.lstm.head(o1["seq_emb"])[..., 0]
    for k in ("edge_logit", "node_logit", "seq_logit", "seq_emb"):
        assert torch.equal(o1[k], o2[k]), k
    assert not torch.equal(o0["node_logit"], o1["node_logit"])
    emb, ref = o1["seq_emb"], o0["seq_emb"]
    kept = emb != 0
    assert 0.4 < float(kept.float().mean()) < 0.6
    torch.testing.assert_close(emb[kept], ref[kept] / 0.5)
    torch.testing.assert_close(head, o1["seq_logit"])


# --- the fused and dense_adj precompute through the port's segment sums -----


def test_fused_edge_views_match_reference(batch):
    # the per-forward edge views, weight totals and inverses, taken through
    # the edges' segment plans (the banded sum over dst, the order-independent
    # one over src), against the reference's jax.ops.segment_sum window by
    # window in float32; the same plans' pointers are sage_row_ptrs'
    from nerrf_tpu.models.graphsage import fused_edge_views as j_views
    from nerrf_tpu_torch.models.graphsage import edge_plans, fused_edge_views
    from nerrf_tpu_torch.ops import sage_row_ptrs

    src, dst = batch["edge_src"], batch["edge_dst"]
    w32 = ((batch["edge_feat"][..., 12] + 0.1)
           * batch["edge_mask"].astype(np.float32)).astype(np.float32)
    N = batch["node_mask"].shape[1]
    t = torch.from_numpy
    plans = edge_plans(t(src), t(dst), N)
    got = fused_edge_views(t(src), t(dst), t(w32), N, plans)
    edges, rest = got[0], got[1:]
    ptrs = sage_row_ptrs(edges[0], edges[2], N)
    assert torch.equal(ptrs[0], plans["dst"].ptr)
    assert torch.equal(ptrs[1], plans["src"].ptr)
    for b in range(src.shape[0]):
        want = j_views(jnp.asarray(src[b]), jnp.asarray(dst[b]),
                       jnp.asarray(w32[b]), N)
        for i, (g, w) in enumerate(zip(edges, want[0])):
            if i < 4:                 # ids in both sorted orders: exact
                np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
            else:
                np.testing.assert_allclose(g[b].numpy(), np.asarray(w),
                                           rtol=1e-6, atol=1e-7)
        for g, w in zip(rest, want[1:]):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6)
    # without plans the views are built the same way
    again = fused_edge_views(t(src), t(dst), t(w32), N)
    assert all(torch.equal(a, b) for a, b in zip(edges, again[0]))


@pytest.mark.parametrize("N,E,pairs", [(7, 60, 9), (40, 300, 300), (16, 0, 1)])
def test_dense_adjacency_matches_reference(N, E, pairs):
    # the raw weighted adjacency through sorted keys and run sums, against
    # the reference's segment_sum onto dst·N + src, duplicate (dst, src)
    # pairs included (pairs < E draws many repeats), weight-0 edges too
    from nerrf_tpu_torch.models.graphsage import dense_adjacency

    rng = np.random.default_rng(N + E)
    B = 3
    pool = rng.integers(0, N, (B, max(pairs, 1), 2))
    pick = rng.integers(0, max(pairs, 1), (B, E))
    dst = np.sort(np.take_along_axis(pool[..., 0], pick, 1), axis=1)
    src = np.take_along_axis(pool[..., 1], pick, 1)
    w = rng.uniform(0.0, 1.0, (B, E)).astype(np.float32)
    w[rng.random((B, E)) < 0.2] = 0.0
    got = dense_adjacency(torch.from_numpy(src.astype(np.int32)),
                          torch.from_numpy(dst.astype(np.int32)),
                          torch.from_numpy(w), N)
    assert got.shape == (B, N, N)
    for b in range(B):
        flat = jnp.asarray(dst[b] * N + src[b], jnp.int32)
        want = jax.ops.segment_sum(jnp.asarray(w[b]), flat,
                                   num_segments=N * N).reshape(N, N)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    if E:
        assert np.unique(dst * N + src, axis=None).size < B * E   # repeats


# --- configs: the reference's checkpoint sidecar and routing table ----------


def test_configs_build_from_reference_checkpoint_meta(tmp_path):
    """The reference's ``save_checkpoint`` sidecar (``model_config.json``,
    with ``lstm.impl``) builds the port's configs as the reference's
    ``load_checkpoint`` builds its own; and a routing table (lists, as JSON
    gives it) picks the same mode per rung in both."""
    import json

    from nerrf_tpu.train.checkpoint import save_checkpoint

    jc = JJointConfig(gnn=JGraphSAGEConfig(hidden=48, num_layers=3),
                      lstm=JLSTMConfig(hidden=40, impl="fused"), fuse=False)
    save_checkpoint(tmp_path / "ck", {"w": np.zeros(2, np.float32)}, jc)
    meta = json.loads((tmp_path / "ck" / "model_config.json").read_text())
    assert meta["lstm"]["impl"] == "fused"
    tc = JointConfig(gnn=GraphSAGEConfig(**meta["gnn"]),
                     lstm=LSTMConfig(**meta["lstm"]), fuse=meta["fuse"])
    assert (tc.gnn.hidden, tc.gnn.num_layers, tc.gnn.aggregation) == (48, 3, "auto")
    assert (tc.lstm.hidden, tc.lstm.impl, tc.fuse) == (40, "fused", False)

    table = [[4096, "fused"], [256, "dense_adj"], [1024, "segment"]]
    jg = JGraphSAGEConfig(**meta["gnn"], routing=table)
    tg = GraphSAGEConfig(**meta["gnn"], routing=table)
    assert tg.routing == jg.routing == ((256, "dense_adj"), (1024, "segment"),
                                        (4096, "fused"))
    for rung in (64, 256, 257, 1024, 1025, 4096):
        assert tg.resolved_aggregation(rung) == jg.resolved_aggregation(rung), rung
    # past the table, and with no bucket given, the port's auto: fused
    assert tg.resolved_aggregation(8192) == tg.resolved_aggregation() == "fused"
    explicit = dataclasses.replace(tg, aggregation="segment")
    assert explicit.resolved_aggregation(64) == "segment"
    for bad in ([[0, "fused"]], [[64, "bogus"]]):
        with pytest.raises(ValueError):
            GraphSAGEConfig(routing=bad)
    with pytest.raises(ValueError):
        LSTMConfig(impl="bogus")
    for impl in ("auto", "rnn"):     # one code path: impl changes nothing
        assert LSTMConfig(impl=impl).impl == impl


def test_forward_takes_its_mode_from_the_routing_table(batch, small_params):
    # GraphSAGET.forward resolves its mode with the padded node bucket: a
    # table that routes this rung to segment gives segment's outputs
    N = batch["node_mask"].shape[1]
    tc = _configs("fused", "float32")[1]
    outs = {}
    for name, gnn in (("routed", dataclasses.replace(
            tc.gnn, aggregation="auto", routing=((N, "segment"),))),
                      ("segment", dataclasses.replace(tc.gnn, aggregation="segment"))):
        tm = load_flax_params(NerrfNet(dataclasses.replace(tc, gnn=gnn)),
                              jax.device_get(small_params))
        with torch.inference_mode():
            outs[name] = tm(*[torch.from_numpy(batch[k]) for k in MODEL_INPUTS])
    for k in ("edge_logit", "node_logit"):
        assert torch.equal(outs["routed"][k], outs["segment"][k]), k
