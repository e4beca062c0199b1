"""The port's StreamNet path (``data/stream.py``, ``ops/attention.py``,
``parallel/ring.py``, ``models/stream.py``, ``parallel/train.py``, the
stream checkpoints) against the JAX package's, on the CPU.

Inputs come from seeded numpy draws or simulated traces; the model's
params are the reference's ``StreamNet.init`` converted by
``convert.stream_state_dict``.  Tolerances:

* attention, float32: rtol = atol = 2e-5 (the reference's own, in
  ``tests/test_stream.py``), against ``_attention_dense`` and against
  ``_attention_local``, including T = 1100, which takes the reference's
  blockwise branch; its gradients against ``jax.grad`` at rtol = atol =
  1e-5 (the same adjoints summed in another order);
* StreamNet, float32: atol = rtol = 1e-4 on the logits
  (measured max |Δ| 1.6e-6 to 1.7e-6 over three traces);
* StreamNet, bfloat16: atol 0.06 on event logits of magnitude up to about
  2.5 (measured max |Δ| 0.024-0.028 over three traces: bf16 keeps 8
  bits, and XLA and PyTorch round the same chain of ops at other points,
  as in ``test_torch_models.py``);
* one training step (float32, dropout 0): the loss within 1e-6, every
  updated param within atol 1e-6 + rtol 1e-5 (measured over two traces: the loss
  within 1.8e-7, the params within 3.5e-7 outside the key bias, whose
  gradient is rounding noise; the test says how it is held).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state

from nerrf_tpu import config as jconfig
from nerrf_tpu.data import SimConfig as JSimConfig
from nerrf_tpu.data import build_stream as jbuild_stream
from nerrf_tpu.data import build_streams as jbuild_streams
from nerrf_tpu.data import simulate_trace as jsimulate_trace
from nerrf_tpu.models import StreamConfig as JStreamConfig
from nerrf_tpu.models import StreamNet as JStreamNet
from nerrf_tpu.parallel import MeshConfig as JMeshConfig
from nerrf_tpu.parallel import make_mesh
from nerrf_tpu.parallel import make_stream_train_step as jmake_stream_train_step
from nerrf_tpu.parallel.ring import _attention_dense as j_attention_dense
from nerrf_tpu.parallel.ring import _attention_local as j_attention_local
from nerrf_tpu.train import checkpoint as jck
from nerrf_tpu_torch import config
from nerrf_tpu_torch.config import MeshConfig
from nerrf_tpu_torch.convert import stream_state_dict
from nerrf_tpu_torch.data import (
    STREAM_FEATURE_DIM,
    SimConfig,
    StreamBatch,
    build_stream,
    build_streams,
    simulate_trace,
)
from nerrf_tpu_torch.models import StreamConfig, StreamNet, build_streamnet, stream_loss
from nerrf_tpu_torch.models import stream as stream_module
from nerrf_tpu_torch.ops import attention, kernels
from nerrf_tpu_torch.parallel import make_stream_train_step, ring_self_attention
from nerrf_tpu_torch.parallel.ring import _attention_local
from nerrf_tpu_torch.train.checkpoint import load_stream_checkpoint, save_stream_checkpoint

SMALL = dict(dim=32, num_heads=2, num_layers=2)
F32 = dict(rtol=1e-4, atol=1e-4)
BF16_ATOL = 0.06
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _sim(seed, attack=True, **kw):
    cfg = dict(duration_sec=30.0, attack=attack, attack_start_sec=8.0,
               num_target_files=4, benign_rate_hz=15.0, seed=seed, **kw)
    return simulate_trace(SimConfig(**cfg)), jsimulate_trace(JSimConfig(**cfg))


def _emptied(trace):
    """The trace with every event marked invalid."""
    ev = dataclasses.replace(trace.events, valid=np.zeros_like(trace.events.valid))
    return dataclasses.replace(trace, events=ev)


def _assert_batches_equal(got, want):
    assert got.feat.dtype == want.feat.dtype and got.mask.dtype == want.mask.dtype
    for k in ("feat", "mask", "label"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)


@pytest.mark.parametrize("case", ["attack", "benign", "empty"])
def test_build_stream_is_bit_equal_to_the_reference(case):
    tr, jtr = _sim(3, attack=case != "benign")
    if case == "empty":
        tr, jtr = _emptied(tr), _emptied(jtr)
    # 100 is no divisor of the event count: the last segment is ragged
    got, want = build_stream(tr, max_len=100), jbuild_stream(jtr, max_len=100)
    _assert_batches_equal(got, want)
    if case == "empty":
        assert got.feat.shape == (0, 100, STREAM_FEATURE_DIM)
    else:
        assert 0 < got.mask[-1].sum() < 100
        # feature 7 is the global inter-event gap
        assert got.feat[0, 0, 7] == 0.0 and (got.feat[got.mask][:, 7] >= 0).all()


def test_build_streams_and_tiling_are_bit_equal_to_the_reference():
    pairs = [_sim(s, attack=s % 2 == 0) for s in (4, 5)]
    got = build_streams([p[0] for p in pairs], max_len=128)
    want = jbuild_streams([p[1] for p in pairs], max_len=128)
    _assert_batches_equal(got, want)
    for n in (3, 8):
        a, b = got.tile_to_multiple(n), want.tile_to_multiple(n)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError):
        StreamBatch.concatenate([build_stream(_emptied(pairs[0][0]))]).tile_to_multiple(2)


def _qkv(b, t, h, d, seed):
    r = np.random.default_rng(seed)
    return [r.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [64, 1100])
def test_attention_dense_matches_the_reference(causal, t):
    q, k, v = _qkv(1, t, 2, 8, seed=t)
    got = attention.attention_dense(*map(torch.from_numpy, (q, k, v)), causal).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (j_attention_dense(jq, jk, jv, causal), j_attention_local(jq, jk, jv, causal)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    # on CPU tensors every public name runs the plain version, no kernel
    attention.reset_launches()
    tq = torch.from_numpy(q)
    for fn in (lambda a, b, c: attention.causal_attention(a, b, c, causal),
               lambda a, b, c: _attention_local(a, b, c, causal),
               lambda a, b, c: ring_self_attention(a, b, c, None, causal=causal)):
        assert torch.equal(fn(tq, torch.from_numpy(k), torch.from_numpy(v)),
                           torch.from_numpy(got))
    assert not any(attention.LAUNCHES.values())


@pytest.mark.parametrize("causal", [True, False])
def test_attention_gradients_match_jax(causal):
    q, k, v = _qkv(2, 70, 2, 16, seed=7)
    cot = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(j_attention_local(a, b, c, causal) * cot),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (attention.causal_attention(*ts, causal) * torch.from_numpy(cot)).sum().backward()
    for name, x, w in zip("qkv", ts, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5,
                                   err_msg=f"d{name}")


def test_attention_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 1, 8)
    with pytest.raises(ValueError, match="head width 8"):
        kernels.launch_attention("attention_fwd", q, q, q, True, 1.0, q, q)
    with pytest.raises(TypeError):
        attention._one_layout(q, q.double(), q)
    with pytest.raises(NotImplementedError, match="A.7"):
        ring_self_attention(q, q, q, MeshConfig(sp=2))
    assert ring_self_attention(q, q, q, MeshConfig(dp=1, sp=1)).shape == q.shape


# chip_smoke.py's bfloat16 bound on the card, kernels against the plain
# version: |Δ| ≤ 2⁻⁷·(1 + Σ|terms|) element by element
BF16_TOL = 2.0 ** -7


def _tensor_core_route(q, k, v, do, causal):
    """The arithmetic of ``flash_attention.cu``'s tensor-core route (bf16 at
    D = 64, 128) in float32 on bf16 values: O from P rounded to bf16 before
    P·V and the denominator from the float32 P; the backward from the
    forward's log-sum-exp and Δ = rowsum(dO∘O) of the bf16 O, dV and dK from
    Pᵀ and dSᵀ rounded to bf16, dQ (the CUDA-core kernel) from the float32
    dS.  Returns O, dQ, dK, dV in bf16."""
    rnd = lambda x: x.bfloat16().float()
    q, k, v, do = (x.float() for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k)
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(), -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.exp((s - m) * scale)
    l = p.sum(-1, keepdim=True)
    o = rnd(torch.einsum("bhqk,bkhd->bqhd", rnd(p), v) / l.permute(0, 2, 1, 3))
    lse = m * scale + torch.log(l)
    p = torch.exp(s * scale - lse)
    delta = (do * o).sum(-1).permute(0, 2, 1)[..., None]
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v) - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", rnd(ds), q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", rnd(p), do)
    return [x.bfloat16() for x in (o, dq, dk, dv)]


def _term_scales(q, k, v, do, causal):
    """Σ|terms| of each element of O, dQ, dK and dV, as chip_smoke.py's
    ``_attention_scales`` forms them: P·|V|; scale·A·|K| and scale·Aᵀ·|Q|
    with A = P∘(|dO|·|V|ᵀ + |Δ|); Pᵀ·|dO|."""
    q, k, v, do = (x.float() for x in (q, k, v, do))
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(), -1e30)
    p = torch.softmax(s, dim=-1)
    delta = (do * torch.einsum("bhqk,bkhd->bqhd", p, v)).sum(-1)
    a = p * (torch.einsum("bqhd,bkhd->bhqk", do.abs(), v.abs())
             + delta.abs().permute(0, 2, 1)[..., None])
    return (torch.einsum("bhqk,bkhd->bqhd", p, v.abs()),
            scale * torch.einsum("bhqk,bkhd->bqhd", a, k.abs()),
            scale * torch.einsum("bhqk,bqhd->bkhd", a, q.abs()),
            torch.einsum("bhqk,bqhd->bkhd", p, do.abs()))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_rounding_meets_the_bf16_bound(causal, d):
    """The tensor-core route's roundings, emulated, against the reference's
    ``_attention_local`` on bf16 inputs at T = 1100 (its blockwise path,
    which rounds P to bf16 itself) and against ``attention_dense``, O and
    the three gradients, within chip_smoke.py's bf16 bound."""
    r = np.random.default_rng(1100 + d + causal)
    q, k, v, do = (r.normal(size=(1, 1100, 2, d)).astype(jnp.bfloat16) for _ in range(4))
    tq, tk, tv, tdo = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
                       for x in (q, k, v, do))
    got = _tensor_core_route(tq, tk, tv, tdo, causal)
    jo, vjp = jax.vjp(lambda a, b, c: j_attention_local(a, b, c, causal),
                      *map(jnp.asarray, (q, k, v)))
    ref = [jo, *vjp(jnp.asarray(do))]
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    dense = attention.attention_dense(*leaves, causal)
    dense.backward(tdo)
    scales = _term_scales(tq, tk, tv, tdo, causal)
    for want_of, wants in (("_attention_local", [torch.from_numpy(np.asarray(x, np.float32))
                                                 for x in ref]),
                           ("attention_dense", [dense.detach()] + [x.grad for x in leaves])):
        for part, g, w, sc in zip(("O", "dQ", "dK", "dV"), got, wants, scales):
            excess = (g.float() - w.float()).abs() - BF16_TOL * (1 + sc)
            assert float(excess.max()) <= 0, \
                f"{part} vs {want_of}: past the bound by {float(excess.max())}"


@pytest.mark.parametrize("case", ["stride", "base", "float32", "streamnet"])
def test_tensor_core_route_checks_the_tma_rules(case):
    """bf16 at D = 128 goes through TMA: a stride off 16 bytes or a base off
    16-byte alignment is refused before any launch; StreamNet's q, k, v
    (views of one qkv projection) are taken; float32 takes the CUDA cores."""
    B, T, dim = 2, 100, 128
    qkv = torch.zeros(B, T, 3 * dim, dtype=torch.bfloat16)
    q, k, v = (x.reshape(B, T, 1, dim) for x in qkv.split(dim, dim=-1))
    out = torch.empty_like(q)
    assert kernels.attention_route("attention_fwd", q.dtype, dim) == "wgmma"
    assert kernels.attention_route("attention_bwd_dq", q.dtype, dim) == "fma"
    if case == "streamnet":
        kernels.check_tma_operands("attention_fwd", q, k, v, out)
        return
    if case == "stride":   # rows of 132 elements: 264 bytes
        q = torch.zeros(B, T, 1, dim + 4, dtype=torch.bfloat16)[..., :dim]
    elif case == "base":   # one element in: 2 bytes off
        q = torch.zeros(B * T * dim + 1, dtype=torch.bfloat16)[1:].view(B, T, 1, dim)
    else:   # the CUDA-core route, which takes any stride
        assert kernels.attention_route("attention_fwd", torch.float32, dim) == "fma"
        return
    with pytest.raises(ValueError, match="TMA"):
        kernels.launch_attention("attention_fwd", q, q, q, True, 1.0, out,
                                 torch.empty(B, 1, T))


@pytest.fixture(scope="module")
def stream_inputs():
    tr, _ = _sim(11)
    sb = build_stream(tr, max_len=128)
    assert len(sb) >= 3 and sb.label.sum() > 0
    return sb


@pytest.fixture(scope="module")
def ref_params(stream_inputs):
    """The reference's init of the small StreamNet (float32 params, as for
    every compute type)."""
    sb = stream_inputs
    return jax.device_get(jax.jit(JStreamNet(JStreamConfig(**SMALL)).init)(
        jax.random.PRNGKey(0), jnp.asarray(sb.feat), jnp.asarray(sb.mask))["params"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streamnet_matches_the_reference(stream_inputs, ref_params, dtype):
    jdt, tdt = _DT[dtype]
    sb = stream_inputs
    want = jax.jit(JStreamNet(JStreamConfig(**SMALL, dtype=jdt, dropout=0.0)).apply)(
        {"params": ref_params}, jnp.asarray(sb.feat), jnp.asarray(sb.mask))
    model = StreamNet(StreamConfig(**SMALL, dtype=tdt, dropout=0.0))
    model.load_state_dict(stream_state_dict(ref_params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(sb.feat), torch.from_numpy(sb.mask))
    ev, want_ev = got["event_logits"].numpy(), np.asarray(want["event_logits"])
    assert ev.dtype == np.float32 and (ev[~sb.mask] == 0).all()
    if dtype == "float32":
        np.testing.assert_allclose(ev, want_ev, **F32)
        np.testing.assert_allclose(got["stream_logit"].numpy(),
                                   np.asarray(want["stream_logit"]), **F32)
    else:
        np.testing.assert_allclose(ev, want_ev, rtol=0, atol=BF16_ATOL)
        assert np.abs(want_ev).max() > 10 * BF16_ATOL  # the logits are not all ~0
    np.testing.assert_array_equal(
        got["stream_logit"].numpy(), np.where(sb.mask, ev, -1e30).max(-1))


def test_one_training_step_matches_the_reference(stream_inputs, ref_params):
    sb = stream_inputs
    cfg_kw = dict(SMALL, dropout=0.0)
    mesh = make_mesh(JMeshConfig(dp=1, tp=1, sp=1), devices=jax.devices()[:1])
    jmodel = JStreamNet(JStreamConfig(**cfg_kw, dtype=jnp.float32), mesh=mesh)
    _, jstep, jplace = jmake_stream_train_step(jmodel, mesh)
    # the state its init_fn builds, from the shared init (one compile less)
    params0 = ref_params
    state = train_state.TrainState.create(apply_fn=jmodel.apply, params=params0,
                                          tx=optax.adamw(1e-3))
    with mesh:
        state, jloss, _ = jstep(state, jplace(sb.arrays()), jax.random.PRNGKey(5))
        params1 = jax.device_get(state.params)

    model = StreamNet(StreamConfig(**cfg_kw, dtype=torch.float32))
    init_fn, step_fn, place = make_stream_train_step(model, MeshConfig(dp=1, sp=1))
    batch = place(sb.arrays())
    st = init_fn(0)
    model.load_state_dict(stream_state_dict(params0), strict=True)
    st, loss, gen = step_fn(st, batch)
    assert gen is None and st.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6, atol=1e-6)
    want = stream_state_dict(params1)
    got = model.state_dict()
    assert got.keys() == want.keys()
    dim = SMALL["dim"]
    for name in want:
        a, b = got[name].numpy(), want[name].numpy()
        if name.endswith("qkv.bias"):
            # the key bias shifts a query's scores by one constant, which the
            # softmax cancels: its gradient is rounding noise, which Adam's
            # first step scales up to lr either way, so only the bound on the
            # step is compared there
            assert np.abs(a[dim:2 * dim]).max() <= 1e-3 * (1 + 1e-5)
            assert np.abs(b[dim:2 * dim]).max() <= 1e-3 * (1 + 1e-5)
            a, b = np.delete(a, np.s_[dim:2 * dim]), np.delete(b, np.s_[dim:2 * dim])
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)


def _grads(cfg, sb, seed):
    model = build_streamnet(cfg, seed=0, device="cpu")
    feat, mask = torch.from_numpy(sb.feat), torch.from_numpy(sb.mask)
    out = model(feat, mask, torch.Generator().manual_seed(seed))
    stream_loss(out, torch.from_numpy(sb.label), mask).backward()
    return {n: p.grad for n, p in model.named_parameters()}


def test_remat_gradients_equal_those_without(stream_inputs, monkeypatch):
    """Dropout masks come from an explicit generator that ``checkpoint``
    does not restore: the block's masks are drawn before it, so the
    recompute applies the same ones."""
    cfg = StreamConfig(**SMALL, dropout=0.3, dtype=torch.float32)
    calls = []
    real = stream_module.checkpoint
    monkeypatch.setattr(stream_module, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with_remat = _grads(cfg, stream_inputs, seed=9)
    assert len(calls) == cfg.num_layers
    without = _grads(dataclasses.replace(cfg, remat=False), stream_inputs, seed=9)
    assert len(calls) == cfg.num_layers
    other_seed = _grads(dataclasses.replace(cfg, remat=False), stream_inputs, seed=10)
    for name, g in without.items():
        assert torch.equal(with_remat[name], g), name
    assert not all(torch.equal(other_seed[n], g) for n, g in without.items())


def test_stream_checkpoint_round_trip(tmp_path):
    cfg = StreamConfig(**SMALL)
    model = build_streamnet(cfg, seed=3, device="cpu")
    cal = {"stream_event_threshold": -0.8885, "calib_f1": 0.5476}
    save_stream_checkpoint(tmp_path / "ck", model.state_dict(), cfg, calibration=cal)
    sd, back, got_cal = load_stream_checkpoint(tmp_path / "ck")
    assert back == cfg and back.dtype is torch.bfloat16
    assert got_cal == {"stream_event_threshold_space": "logit", **cal}
    assert sd.keys() == model.state_dict().keys()
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    # the sidecar is the reference's, field for field
    jck.save_stream_checkpoint(tmp_path / "jk", {"w": np.zeros(2, np.float32)},
                               JStreamConfig(**SMALL), calibration=cal)
    ours = json.loads((tmp_path / "ck" / "stream_config.json").read_text())
    theirs = json.loads((tmp_path / "jk" / "stream_config.json").read_text())
    assert ours == theirs
    # a space the caller gave is kept; the reference loads the port's sidecar
    save_stream_checkpoint(tmp_path / "ck", sd, cfg,
                           calibration={"stream_event_threshold": 1.0,
                                        "stream_event_threshold_space": "prob"})
    assert load_stream_checkpoint(tmp_path / "ck")[2]["stream_event_threshold_space"] == "prob"
    ours["features"]["stream"] = STREAM_FEATURE_DIM + 1
    (tmp_path / "ck" / "stream_config.json").write_text(json.dumps(ours))
    with pytest.raises(ValueError, match="feature layout changed"):
        load_stream_checkpoint(tmp_path / "ck")
    ours["features"]["stream"] = STREAM_FEATURE_DIM
    ours["schema_version"] = 99
    (tmp_path / "ck" / "stream_config.json").write_text(json.dumps(ours))
    with pytest.raises(ValueError, match="newer version"):
        load_stream_checkpoint(tmp_path / "ck")


def test_experiment_stream_is_the_model_config():
    exp = config.EXPERIMENTS["multihost-online"]
    assert config.StreamConfig is StreamConfig
    assert type(exp.stream) is StreamConfig and exp.stream == StreamConfig()
    assert exp.to_json() == jconfig.EXPERIMENTS["multihost-online"].to_json()
    with pytest.raises(NotImplementedError, match="A.7"):
        make_stream_train_step(StreamNet(StreamConfig(**SMALL)), MeshConfig(dp=2))
