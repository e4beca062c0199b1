"""The port's disk corpus (nerrf_tpu_torch.train.corpus) and its sharded
trainer (loop.train_sharded_stream) against the JAX package's, on the CPU.

One tiny spec (the reference's own test spec: 0.2 h of 120 s traces,
shards of 12 windows, 64n/128e graphs) is generated by both packages.
Tolerances:

* shards and manifest: byte-identical files, equal manifests apart from the
  wall-clock fields ``gen_seconds`` and ``auto_fit.fit_seconds``;
* readers, shard order, batch draws: equal;
* the sharded trainer's losses over two shard boundaries, from the same
  converted init (float32, dropout 0, ``segment``): rtol 1e-4, the limit of
  ``test_train_step_tracks_reference``;
* a resumed run's params, optimizer state and step: bit-equal.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerrf_tpu.graph import GraphConfig as JGraphConfig
from nerrf_tpu.models.joint import JointConfig as JJointConfig
from nerrf_tpu.train import corpus as jcorpus
from nerrf_tpu.train import data as jdata
from nerrf_tpu.train import loop as jloop
from nerrf_tpu_torch.convert import load_flax_params
from nerrf_tpu_torch.graph import GraphConfig
from nerrf_tpu_torch.models import JointConfig, NerrfNet
from nerrf_tpu_torch.train import corpus as tcorpus
from nerrf_tpu_torch.train import data as tdata
from nerrf_tpu_torch.train import loop as tloop
from nerrf_tpu_torch.train import run
from nerrf_tpu_torch.train.elastic import _restore_full, latest_step

GRAPH = dict(window_sec=45.0, stride_sec=15.0, max_nodes=64, max_edges=128)
SEQS = dict(seq_len=30, max_seqs=32)
SPEC = dict(hours=0.2, duration_sec=120.0, num_target_files=6,
            benign_rate_hz=8.0, shard_windows=12, eval_fraction=0.34)
LOSS_RTOL = 1e-4
WALL_CLOCK = ("gen_seconds",)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("corpora")
    port = tcorpus.generate_corpus(
        tmp / "port", tcorpus.CorpusSpec(**SPEC),
        dataset=tdata.DatasetConfig(graph=GraphConfig(**GRAPH), **SEQS))
    ref = jcorpus.generate_corpus(
        tmp / "ref", jcorpus.CorpusSpec(**SPEC),
        dataset=jdata.DatasetConfig(graph=JGraphConfig(**GRAPH), **SEQS))
    return dict(port=tmp / "port", ref=tmp / "ref", man=port, jman=ref)


def _without_wall_clock(man: dict) -> dict:
    man = {k: v for k, v in man.items() if k not in WALL_CLOCK}
    man["auto_fit"] = {k: v for k, v in man["auto_fit"].items() if k != "fit_seconds"}
    return man


def test_shards_and_manifest_are_byte_identical(corpora):
    port, ref = corpora["port"], corpora["ref"]
    files = sorted(p.relative_to(ref) for p in ref.rglob("*.npy"))
    assert files == sorted(p.relative_to(port) for p in port.rglob("*.npy"))
    assert len(files) > 2 * 17  # several shards of every array
    for rel in files:
        assert (port / rel).read_bytes() == (ref / rel).read_bytes(), rel
    man = json.loads((port / "manifest.json").read_text())
    jman = json.loads((ref / "manifest.json").read_text())
    assert man == corpora["man"] and jman == corpora["jman"]
    assert _without_wall_clock(man) == _without_wall_clock(jman)
    kinds = [s["kind"] for s in man["shards"]]
    assert kinds.count("shard") >= 3 and kinds.count("eval") >= 1


def test_each_package_reads_the_others_corpus(corpora):
    for mine, theirs in ((tcorpus.ShardedCorpus(corpora["ref"]),
                          jcorpus.ShardedCorpus(corpora["ref"])),
                         (tcorpus.ShardedCorpus(corpora["port"]),
                          jcorpus.ShardedCorpus(corpora["port"]))):
        assert mine.train_shards == theirs.train_shards
        assert mine.eval_shards == theirs.eval_shards
        assert (mine.hours, mine.train_windows) == (theirs.hours, theirs.train_windows)
        for upcast in (False, True):
            a = mine.load_shard(mine.train_shards[0], upcast=upcast)
            b = theirs.load_shard(theirs.train_shards[0], upcast=upcast)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert mine.load_shard(mine.train_shards[0])["node_feat"].dtype == np.float16
        ev, jev = mine.eval_dataset(), theirs.eval_dataset()
        assert len(ev) == len(jev) > 0
        for k in ev.arrays:
            np.testing.assert_array_equal(ev.arrays[k], jev.arrays[k], err_msg=k)


@pytest.mark.parametrize("epoch_seed", [0, 1, 7])
def test_iter_train_shards_order_is_equal(corpora, epoch_seed):
    mine = tcorpus.ShardedCorpus(corpora["port"])
    theirs = jcorpus.ShardedCorpus(corpora["port"])
    got = [s["node_feat"] for s in mine.iter_train_shards(epoch_seed)]
    want = [s["node_feat"] for s in theirs.iter_train_shards(epoch_seed)]
    assert len(got) == len(want) == len(mine.train_shards)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_auto_fit_drops_nothing(corpora):
    man = corpora["man"]
    fit, cap = man["auto_fit"], man["graph_capacity"]
    assert man["dropped"] == {"events": 0, "nodes": 0, "edges": 0, "windows": 0}
    assert cap["max_nodes"] >= fit["max_window_nodes"]
    assert cap["max_edges"] >= fit["max_window_edges"]
    shard = next(s["name"] for s in man["shards"] if s["kind"] == "shard")
    nf = np.load(corpora["port"] / shard / "node_feat.npy", mmap_mode="r")
    assert nf.shape[1] == cap["max_nodes"]


def test_generation_is_idempotent_and_main_writes_the_same(corpora, tmp_path, capsys):
    man = tcorpus.generate_corpus(corpora["port"], tcorpus.CorpusSpec(hours=5.0))
    assert man == corpora["man"]  # a complete manifest short-circuits
    assert tcorpus.main(["--out", str(tmp_path / "cli"), "--hours", "0.05",
                         "--duration-sec", "90", "--benign-rate-hz", "6",
                         "--files", "4", "--seed", "3", "--shard-windows", "8"]) == 0
    spec = jcorpus.CorpusSpec(hours=0.05, duration_sec=90.0, benign_rate_hz=6.0,
                              num_target_files=4, base_seed=3, shard_windows=8)
    want = jcorpus.generate_corpus(tmp_path / "ref", spec)
    got = json.loads((tmp_path / "cli" / "manifest.json").read_text())
    assert _without_wall_clock(got) == _without_wall_clock(want)
    assert "[gen] manifest:" in capsys.readouterr().out


class _FailingCorpus:
    def iter_train_shards(self, epoch_seed):
        raise OSError("disk gone")
        yield  # pragma: no cover


def test_reader_failure_raises_in_the_trainer(corpora, tmp_path):
    cfg = tloop.TrainConfig(model=JointConfig().small, batch_size=4, num_steps=5,
                            eval_every=0)
    with pytest.raises(RuntimeError, match="shard read failed"):
        tloop.train_sharded_stream(_FailingCorpus(), cfg, device="cpu")
    bad = tmp_path / "bad"
    shutil.copytree(corpora["port"], bad)
    for s in json.loads((bad / "manifest.json").read_text())["shards"]:
        if s["kind"] == "shard":
            (bad / s["name"] / "node_feat.npy").write_bytes(b"garbage")
    with pytest.raises(RuntimeError, match="shard read failed"):
        tloop.train_sharded_stream(tcorpus.ShardedCorpus(bad), cfg, device="cpu")


def _tiny_f32_segment():
    jc, tc = JJointConfig(), JointConfig()
    jc = dataclasses.replace(
        jc, gnn=dataclasses.replace(jc.gnn, hidden=16, num_layers=2, dtype=jnp.float32,
                                    dropout=0.0),
        lstm=dataclasses.replace(jc.lstm, hidden=16, num_layers=1, dtype=jnp.float32,
                                 dropout=0.0))
    tc = dataclasses.replace(
        tc, gnn=dataclasses.replace(tc.gnn, hidden=16, num_layers=2, dtype=torch.float32,
                                    dropout=0.0, aggregation="segment"),
        lstm=dataclasses.replace(tc.lstm, hidden=16, num_layers=1, dtype=torch.float32,
                                 dropout=0.0))
    return jc, tc


@pytest.fixture(scope="module")
def stream_runs(corpora):
    """Both sharded trainers over the same corpus from the same init: 7 steps
    of 4 windows, one pass a 12-window shard (3 steps), so the run crosses two
    shard boundaries; the port's gathers recorded."""
    jc, tc = _tiny_f32_segment()
    kw = dict(batch_size=4, num_steps=7, warmup_steps=1, seed=2, eval_every=1)
    jcfg, cfg = jloop.TrainConfig(model=jc, **kw), tloop.TrainConfig(model=tc, **kw)
    init, gathers = {}, []
    real_init, real_gather = jloop.init_state, tloop._gather

    def recording_init(model, c, sample, rng):
        state = real_init(model, c, sample, rng)
        init.setdefault("params", jax.device_get(state.params))
        return state

    def reference_init(c, device=None):
        model = load_flax_params(NerrfNet(c.model), init["params"]).train()
        return tloop.TrainState(model=model, optimizer=tloop.make_tx(model, c))

    def recording_gather(data, idx):
        gathers.append((data["node_feat"].numpy().copy(), idx.numpy().copy()))
        return real_gather(data, idx)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "init_state", recording_init)
        mp.setattr(tloop, "init_state", reference_init)
        mp.setattr(tloop, "_gather", recording_gather)
        want = jloop.train_sharded_stream(jcorpus.ShardedCorpus(corpora["port"]),
                                          jcfg, passes_per_shard=1, full_history=True)
        got = tloop.train_sharded_stream(tcorpus.ShardedCorpus(corpora["port"]),
                                         cfg, passes_per_shard=1, full_history=True,
                                         device="cpu")
    return dict(cfg=cfg, want=want, got=got, gathers=gathers)


def test_sharded_stream_draws_as_the_reference(corpora, stream_runs):
    # the reference's loop replayed: shard order from iter_train_shards(seed
    # + epoch), per shard _shard_steps steps, indices from default_rng((seed,
    # steps_done)) drawn in step order
    cfg, gathers = stream_runs["cfg"], stream_runs["gathers"]
    sc = jcorpus.ShardedCorpus(corpora["port"])
    order = np.random.default_rng((cfg.seed, 0))
    shards = [s for epoch in range(3) for s in sc.iter_train_shards(cfg.seed + epoch)]
    want, done = [], 0
    for shard in shards:
        n = shard["node_feat"].shape[0]
        for _ in range(min(jloop._shard_steps(shard, cfg, 1), cfg.num_steps - done)):
            want.append((shard["node_feat"], order.choice(n, size=min(cfg.batch_size, n),
                                                          replace=False)))
            done += 1
        if done == cfg.num_steps:
            break
    assert len(gathers) == len(want) == cfg.num_steps
    assert stream_runs["got"].info["shards"] == 3
    for (data, idx), (jdata_, jidx) in zip(gathers, want):
        np.testing.assert_array_equal(idx, jidx)
        assert data.dtype == np.float16  # cast to f32 after the gather
        np.testing.assert_array_equal(data, jdata_)


def test_sharded_stream_losses_track_the_reference(stream_runs):
    want = [h["loss"] for h in stream_runs["want"].history]
    got = [h["loss"] for h in stream_runs["got"].history]
    assert [h["step"] for h in stream_runs["got"].history] == list(range(7))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert stream_runs["got"].state.step == 7
    assert np.isfinite(got).all() and stream_runs["got"].steps_per_sec > 0


def test_sharded_stream_resume_restores_the_state(corpora, tmp_path):
    sc = tcorpus.ShardedCorpus(corpora["port"])
    cfg = tloop.TrainConfig(model=JointConfig().small, batch_size=4, num_steps=6,
                            warmup_steps=1, eval_every=0)
    first = tloop.train_sharded_stream(sc, cfg, passes_per_shard=1, device="cpu",
                                       ckpt_dir=tmp_path, save_every=4)
    assert latest_step(tmp_path) == 6
    restored = _restore_full(tmp_path, 6, tloop.init_state(cfg, "cpu"))
    assert restored.step == first.state.step == 6
    for (name, a), b in zip(first.state.model.state_dict().items(),
                            restored.model.state_dict().values()):
        assert torch.equal(a, b), name
    sa, sb = first.state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    lines = []
    more = tloop.train_sharded_stream(sc, dataclasses.replace(cfg, num_steps=8),
                                      passes_per_shard=1, device="cpu",
                                      ckpt_dir=tmp_path, save_every=4, log=lines.append)
    assert "resumed from step 6" in lines and more.state.step == 8
    assert latest_step(tmp_path) == 8


def test_compile_cache_is_refused(corpora):
    with pytest.raises(NotImplementedError, match="B.D1"):
        tloop.train_sharded_stream(tcorpus.ShardedCorpus(corpora["port"]),
                                   compile_cache=object(), device="cpu")


def test_run_experiment_trains_from_the_disk_corpus(corpora, tmp_path):
    exp = {
        "name": "tiny-disk", "description": "the disk-corpus branch",
        "corpus": {"num_traces": 2, "attack_fraction": 0.5, "base_seed": 42,
                   "duration_sec": 60.0, "num_target_files": 4,
                   "benign_rate_hz": 10.0, "eval_fraction": 0.5},
        "dataset": {"graph": dict(GRAPH), **SEQS, "min_events": 4},
        "train": {"model": {"gnn": {"hidden": 16, "num_layers": 2, "dropout": 0.0,
                                    "dtype": "float32", "aggregation": "segment"},
                            "lstm": {"hidden": 16, "num_layers": 1, "dropout": 0.0,
                                     "dtype": "float32"},
                            "fuse": True},
                  "batch_size": 4, "num_steps": 8, "warmup_steps": 2,
                  "eval_every": 4, "seed": 0},
        "corpus_dir": str(corpora["port"]),
    }
    (tmp_path / "disk.json").write_text(json.dumps(exp))
    report = run.run_experiment(str(tmp_path / "disk.json"), tmp_path / "out",
                                ckpt_every=4, calibrate=False, device="cpu")
    assert json.loads((tmp_path / "out" / "metrics.json").read_text()) == report
    man = corpora["man"]
    assert (report["corpus_train_windows"], report["corpus_eval_windows"]) == \
        (man["train_windows"], man["eval_windows"])
    assert report["corpus_hours"] == round(man["hours"], 2)
    assert report["metrics"]["num_edges_eval"] == float(
        tcorpus.ShardedCorpus(corpora["port"]).eval_dataset().arrays["edge_mask"].sum())
    assert latest_step(tmp_path / "out" / "train_state") == 8
    assert (tmp_path / "out" / "model" / "params.pt").exists()
