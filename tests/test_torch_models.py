"""The port's NerrfNet (nerrf_tpu_torch.models) against the JAX package's,
on the same windows with converted weights.

Flax params from ``NerrfNet.init`` go through ``nerrf_tpu_torch.convert``;
inputs are real window samples of a small simulated attack trace, lowered by
the JAX package.  Tolerances:

* float32: atol = rtol = 1e-4 on logits (measured max |Δ| about 1.3e-6:
  the same arithmetic, summed in another order);
* bfloat16: atol 0.1 (measured max |Δ| about 0.035 on logits of magnitude
  ≤ 2 — bf16 keeps 8 bits, and XLA and PyTorch round at different points
  of the same ops, e.g. elementwise chains XLA rounds per op).
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
from nerrf_tpu_torch.convert import (
    flax_to_state_dict, load_flax_params, lstm_state_dict)
from nerrf_tpu_torch.models import (
    GraphSAGEConfig, ImpactLSTM, JointConfig, LSTMConfig, NerrfNet,
    build_nerrfnet)
from nerrf_tpu_torch.models.layers import LayerNorm, gelu
from nerrf_tpu_torch.pipeline import MODEL_INPUTS

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL = 0.1
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def batch():
    tr = simulate_trace(SimConfig(duration_sec=60.0, attack=True,
                                  attack_start_sec=20.0, num_target_files=4,
                                  benign_rate_hz=20.0, seed=2))
    samples = windows_of_trace(tr, DatasetConfig(
        graph=GraphConfig(window_sec=45.0, stride_sec=20.0,
                          max_nodes=64, max_edges=128),
        seq_len=24, max_seqs=32))
    assert len(samples) >= 2
    return {k: np.stack([s[k] for s in samples]) for k in MODEL_INPUTS}


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


@pytest.mark.parametrize("mode", ["fused", "dense_adj"])
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
