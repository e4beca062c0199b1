"""The port's ladder tuner (``nerrf_tpu_torch.tune``) against the JAX
package's (``nerrf_tpu.tune``), on the CPU.

* Over ``tests/test_tune.py``'s golden corpus, with no analytic surface and
  the same kernel-bench dict, the port's artifact equals the reference's
  field for field; so does the analytic-anchored fit on the small model,
  whose serve FLOPs the two packages count alike (``test_torch_devtime``).
  The reference's model config is given ``aggregation="fused"``: that is
  what the port's ``auto`` resolves to, and the mode the fit assigns the
  measured buckets.
* Without a kernel bench the port cites its ``DENSE_FUSED_PRIOR_NODES``
  (the reference's authored crossover, named as such): the artifact differs
  from the reference's only in that provenance line.
* The rung gate: the port's (the CUDA launchers' limits) agrees with the
  reference's (the Pallas VMEM audit) at every candidate rung but
  (16384, 32768), where the reference's refuses and the port's passes; a
  rung the port's gate fails is one a launcher refuses.
* A tuned routing gives ``NerrfNet`` logits within the models' float32 1e-4
  of the reference's under the same routing, in each of the three modes.
* The cases of ``tests/test_tune.py`` but the AOT re-export's (the compile
  cache, ROADMAP A.7): determinism, the static ladder in the candidate set,
  the analytic anchor, single-marginal tails, file demand, the refusals,
  the artifact's round trip, validation, atomic save, and what it applies.
"""

import dataclasses
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from nerrf_tpu import tune as jtune
from nerrf_tpu.models.graphsage import GraphSAGEConfig as JGraphSAGEConfig
from nerrf_tpu.tune import search as jsearch
from nerrf_tpu_torch import cli
from nerrf_tpu_torch.models import GraphSAGEConfig, JointConfig, NerrfNet
from nerrf_tpu_torch.ops import kernels
from nerrf_tpu_torch.serve import ServeConfig
from nerrf_tpu_torch.tune import (
    ARTIFACT_KIND,
    ARTIFACT_SCHEMA,
    DENSE_FUSED_PRIOR_NODES,
    TuneError,
    apply_to_model_config,
    apply_to_serve_config,
    budget_clean,
    build_artifact,
    demand_points,
    fit_cost_model,
    load_artifact,
    load_kernel_bench_crossover,
    save_artifact,
    tune,
    validate_artifact,
)
from nerrf_tpu_torch.tune import search

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_tune import _dist, golden_corpus  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
KERNEL_BENCH = ROOT / "benchmarks" / "results" / "kernel_bench_cpu.json"
# the reference's model config the port's ``auto`` matches: fused everywhere
JFUSED = JGraphSAGEConfig(aggregation="fused")
F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """One intra-op thread while a test runs: the CPU is shared with other
    test processes, and small tensor ops would wait on a thread pool."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _kernel_benches():
    return {"checked-in": load_kernel_bench_crossover(KERNEL_BENCH),
            "card-like": {"nodes": 700.0, "source": "a card's bench",
                          "degraded": False}}


# -- the fit and search, against the reference ---------------------------------

@pytest.mark.parametrize("bench", sorted(_kernel_benches()))
def test_golden_artifact_equals_the_references(bench):
    kb = _kernel_benches()[bench]
    assert kb is not None
    got = tune(golden_corpus(), kernel_bench=kb)
    want = jtune.tune(golden_corpus(), model_cfg=JFUSED, kernel_bench=kb)
    assert got == want
    # and under the reference's CPU mode, given to both
    assert tune(golden_corpus(), model_cfg=GraphSAGEConfig(aggregation="segment"),
                kernel_bench=kb) == jtune.tune(golden_corpus(), kernel_bench=kb)


def test_without_a_kernel_bench_only_the_prior_is_named_otherwise():
    got, want = tune(golden_corpus()), jtune.tune(golden_corpus(),
                                                  model_cfg=JFUSED)
    got_kb = got["fit"]["provenance"].pop("kernel_bench")
    want_kb = want["fit"]["provenance"].pop("kernel_bench")
    assert got == want
    assert got_kb["nodes"] == want_kb["nodes"] == float(DENSE_FUSED_PRIOR_NODES)
    assert "DENSE_FUSED_PRIOR_NODES" in got_kb["source"]
    assert "not on the card" in got_kb["source"]


@pytest.fixture(scope="module")
def analytic_pair():
    """The small model's analytic serve FLOPs at two rungs, counted by each
    package (the reference's plain route, the port's on ``meta``)."""
    from nerrf_tpu import devtime as jdevtime
    from nerrf_tpu.models import JointConfig as JJointConfig
    from nerrf_tpu.models import NerrfNet as JNerrfNet
    from nerrf_tpu.serve import ServeConfig as JServeConfig
    from nerrf_tpu.serve import init_untrained_params
    from nerrf_tpu.train.loop import make_eval_fn as jmake_eval_fn
    from nerrf_tpu_torch.devtime import serve_program_costs

    ladder = ((256, 512, 64), (1024, 2048, 128))
    jcfg = JJointConfig().small
    jcfg = dataclasses.replace(jcfg, gnn=dataclasses.replace(
        jcfg.gnn, aggregation="segment"))
    jserve = JServeConfig(buckets=ladder)
    jmodel = JNerrfNet(jcfg)
    params = jax.jit(lambda: init_untrained_params(jmodel, jserve))()
    want = jdevtime.serve_program_costs(jmake_eval_fn(jmodel), params, jserve)
    with torch.device("meta"):
        model = NerrfNet(JointConfig().small)
    got = serve_program_costs(model, ServeConfig(buckets=ladder))
    return ({t: c.flops for t, c in got.items()},
            {t: c.flops for t, c in want.items()})


def test_analytic_anchored_fit_equals_the_references(analytic_pair):
    got_a, want_a = analytic_pair
    assert got_a == want_a and len(got_a) == 2
    corpus = golden_corpus()
    del corpus["bucket_cost"]["2048n/4096e/256s"]
    kb = _kernel_benches()["checked-in"]
    got = tune(corpus, model_cfg=JointConfig().small, analytic=got_a,
               kernel_bench=kb)
    jsmall = JGraphSAGEConfig(hidden=32, num_layers=4, aggregation="fused")
    want = jtune.tune(corpus, model_cfg=jsmall, analytic=want_a, kernel_bench=kb)
    assert got == want
    assert got["fit"]["analytic_alpha"] is not None
    assert "analytic_prior" in got["fit"]["rung_sources"].values()


# -- the rung gate ---------------------------------------------------------------

def _candidate_rungs():
    out, n = [], 256
    while n <= search.MAX_CANDIDATE_NODES:
        e = 2 * n
        while e <= 2 * search.MAX_CANDIDATE_NODES:
            out.append((n, e))
            e <<= 1
        n <<= 1
    return out


@pytest.mark.parametrize("rung", _candidate_rungs(), ids=lambda r: f"{r[0]}n{r[1]}e")
def test_rung_gate_agrees_with_the_references(rung):
    """Every rung the candidate enumeration can propose: the same verdict
    as the reference's VMEM audit, but at (16384, 32768): there the fused
    Pallas kernel's full-height message block overflows the TPU core's
    VMEM, while the CUDA kernels stream their rows and launch."""
    n, e = rung
    if rung == (16384, 32768):
        assert jsearch.budget_clean(n, e) is False
        assert budget_clean(n, e) is True
    else:
        assert budget_clean(n, e) == jsearch.budget_clean(n, e) is True


def test_rung_gate_fails_exactly_where_a_launcher_refuses(monkeypatch):
    """The gate reads the launchers' own checks: a rung it passes goes past
    every launcher's checks to the launch, and a rung it fails is refused
    by a launcher before any card is touched (meta tensors here)."""
    launched = []
    monkeypatch.setattr(kernels, "_launch", lambda name, *a, **k: launched.append(name))
    monkeypatch.setattr(kernels, "_stream", lambda device: 0)
    monkeypatch.setattr(kernels, "_scratch", lambda *a: 0)

    def launch_all(B, n, e, F):
        def t(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="meta")

        idx = t(B, e, dtype=torch.int32)
        kernels.launch_gather("gather_rows", t(B, n, F), idx, t(B, e, F))
        ptr = t(B, n + 1, dtype=torch.int32)
        kernels.launch_sage_aggregate(t(B, n, F), ptr, idx, t(B, e), ptr, idx,
                                      t(B, e), t(B, n, F))
        plan = type("Plan", (), {"ptr": ptr, "perm": None,
                                 "num_chunk_slots": n + -(-e // 32)})()
        kernels.launch_segment_sum("segment_sum", t(B, e, F), plan, t(B, n, F))

    ok = kernels.rung_limits(4096, 8192, 160, 8)
    assert ok["ok"] and ok["refusals"] == []
    launch_all(8, 4096, 8192, 160)
    assert launched == ["gather_rows", "sage_aggregate", "segment_sum"]
    for n, e, F, B in ((4096, 8192, 384, 8),          # past MAX_ROW_WIDTH
                       (1 << 20, 1 << 22, 256, 8),    # past 32-bit indexing
                       (256, 512, 160, 70000)):       # past the grid's y
        verdict = kernels.rung_limits(n, e, F, B)
        assert not verdict["ok"] and verdict["refusals"]
        with pytest.raises(ValueError):
            launch_all(B, n, e, F)
    # the scratch share is the one limit no launcher checks: stated instead
    big = kernels.rung_limits(1 << 20, 1 << 21, 256, 64)
    assert big["scratch_bytes"] > big["scratch_limit_bytes"] == int(
        kernels.CARD_MEMORY_BYTES * kernels.SCRATCH_SHARE)
    assert any("scratch" in r for r in big["refusals"])


def test_scratch_bytes_are_what_the_launchers_ask_for(monkeypatch):
    asked = []
    monkeypatch.setattr(kernels, "_launch", lambda *a, **k: None)
    monkeypatch.setattr(kernels, "_stream", lambda device: 0)
    monkeypatch.setattr(kernels, "_scratch",
                        lambda device, stream, dtype, count: asked.append(
                            count * torch.empty((), dtype=dtype).element_size()))
    B, n, e, F = 8, 1024, 2048, 160
    t = lambda *s, dtype=torch.float32: torch.empty(s, dtype=dtype, device="meta")  # noqa: E731
    idx, ptr = t(B, e, dtype=torch.int32), t(B, n + 1, dtype=torch.int32)
    kernels.launch_sage_aggregate(t(B, n, F), ptr, idx, t(B, e), ptr, idx, t(B, e),
                                  t(B, n, F))
    assert sum(asked) == kernels.sage_scratch_bytes(B, n, e, F)
    asked.clear()
    plan = type("Plan", (), {"ptr": ptr, "perm": None,
                             "num_chunk_slots": n + -(-e // 32)})()
    kernels.launch_segment_sum("segment_sum", t(B, e, F), plan, t(B, n, F))
    assert sum(asked) == kernels.segment_scratch_bytes(B, n, e, F)


# -- tuned routing through the model ----------------------------------------------

@pytest.mark.parametrize("mode", ["dense_adj", "segment", "fused"])
def test_tuned_routing_logits_match_the_references(mode):
    from test_torch_models import F32_TOL as MODELS_F32_TOL
    from test_torch_models import _configs, _run_both, _windows
    from nerrf_tpu_torch.pipeline import MODEL_INPUTS

    assert MODELS_F32_TOL == F32_TOL
    batch = _windows(MODEL_INPUTS)
    N = batch["node_mask"].shape[1]
    art = build_artifact(((N, 128, 32), (4 * N, 512, 64)),
                         ((N, mode), (4 * N, "fused")), {}, {})
    jc, tc = _configs("fused", "float32")
    jc = dataclasses.replace(jc, gnn=dataclasses.replace(jc.gnn, aggregation="auto"))
    tc = dataclasses.replace(tc, gnn=dataclasses.replace(tc.gnn, aggregation="auto"))
    jc, tc = jtune.apply_to_model_config(art, jc), apply_to_model_config(art, tc)
    assert tc.gnn.resolved_aggregation(N) == jc.gnn.resolved_aggregation(N) == mode
    want, got = _run_both(jc, tc, batch)
    for k in ("edge_logit", "node_logit", "seq_logit"):
        np.testing.assert_allclose(got[k], want[k], **F32_TOL, err_msg=k)


# -- the cases of tests/test_tune.py ------------------------------------------------

def test_golden_corpus_deterministic_artifact():
    art = tune(golden_corpus())
    art2 = tune(json.loads(json.dumps(golden_corpus())))
    assert art == art2
    assert art["kind"] == ARTIFACT_KIND and art["schema"] == ARTIFACT_SCHEMA
    assert art["buckets"] == [[512, 1024, 32], [1024, 2048, 128],
                              [2048, 4096, 128]]
    assert set(dict(art["routing"])) == {512, 1024, 2048}
    exp = art["expected"]
    assert (exp["tuned_device_seconds_per_window"]
            < exp["static_device_seconds_per_window"])
    assert art["fit"]["rung_sources"]["1024n/2048e/128s"] == "measured"
    assert art["fit"]["rung_sources"]["512n/1024e/32s"] == "measured_fit"


def test_static_ladder_is_in_the_candidate_set():
    art = tune(golden_corpus(),
               static_buckets=((1024, 2048, 128), (2048, 4096, 256)))
    assert art["expected"]["improvement"] >= 0.0


def test_thin_corpus_anchors_on_analytic_prior():
    corpus = golden_corpus()
    del corpus["bucket_cost"]["2048n/4096e/256s"]
    analytic = {"1024n/2048e/128s": 2.0e9, "512n/1024e/128s": 6.0e8,
                "2048n/4096e/256s": 7.0e9}
    model = fit_cost_model(corpus, analytic=analytic)
    assert model.analytic_alpha is not None
    assert model.source((512, 1024, 32), "fused") == "analytic_prior"
    assert model.auto_mode((1024, 2048, 128)) == "fused"
    assert model.source((1024, 2048, 128), "fused") == "measured"
    art = tune(corpus, analytic=analytic)
    assert "analytic_prior" in art["fit"]["rung_sources"].values()


def test_demand_points_see_single_marginal_tails():
    corpus = golden_corpus()
    corpus["window_size_distribution"] = {
        "nodes": _dist([100] * 90 + [150] * 10),
        "edges": _dist([200] * 90 + [3000] * 10),
        "files": _dist([20] * 100)}
    points = demand_points(corpus)
    assert any(p.edges >= 3000 and p.nodes <= 256 for p in points)


def test_search_covers_file_demand_instead_of_truncating():
    art = tune(golden_corpus())
    assert max(b[2] for b in art["buckets"]) >= 128


def test_refusals_are_one_line_tune_errors():
    with pytest.raises(TuneError, match="empty"):
        tune(dict(golden_corpus(), windows_observed=0))
    with pytest.raises(TuneError, match="bucket_cost"):
        tune(dict(golden_corpus(), bucket_cost=None))
    with pytest.raises(TuneError, match="kind"):
        tune({"kind": "something_else"})


def test_cli_tune_refuses_an_empty_corpus_and_writes_a_loadable_artifact(tmp_path):
    import contextlib
    import io

    def run(argv):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main([str(a) for a in argv])
        return rc, out.getvalue(), err.getvalue()

    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps(dict(golden_corpus(), windows_observed=0)))
    rc, out, err = run(["tune", empty])
    assert rc == 1 and out == "" and "refusing to tune" in err
    assert run(["tune", tmp_path / "missing.json"])[0] == 1
    corpus = tmp_path / "corpus.json"
    corpus.write_text(json.dumps(golden_corpus()))
    rc, out, _ = run(["tune", corpus, "--out", tmp_path / "tuned.json"])
    assert rc == 0 and out == ""
    # no kernel bench by default: the port cites its prior
    assert load_artifact(tmp_path / "tuned.json") == tune(golden_corpus())
    rc, out, _ = run(["tune", corpus, "--kernel-bench", KERNEL_BENCH, "--json"])
    assert rc == 0 and json.loads(out) == tune(
        golden_corpus(), kernel_bench=load_kernel_bench_crossover(KERNEL_BENCH))


def test_artifact_roundtrip_and_validation(tmp_path):
    art = tune(golden_corpus())
    path = tmp_path / "tuned.json"
    save_artifact(path, art)
    assert load_artifact(path) == art
    with pytest.raises(TuneError):
        load_artifact(tmp_path / "missing.json")
    with pytest.raises(TuneError, match="kind"):
        validate_artifact(dict(art, kind="other"))
    with pytest.raises(TuneError, match="schema"):
        validate_artifact(dict(art, schema=ARTIFACT_SCHEMA + 1))
    with pytest.raises(TuneError):
        validate_artifact(dict(art, buckets=[]))
    with pytest.raises(TuneError):
        validate_artifact(dict(art, routing=[[512, "nonsense_mode"]]))
    # the reference reads the port's artifact, and the port the reference's
    assert jtune.load_artifact(path) == art
    jtune.save_artifact(tmp_path / "ref.json", jtune.tune(golden_corpus()))
    validate_artifact(load_artifact(tmp_path / "ref.json"))


def test_artifact_applies_to_serve_and_model_config():
    art = tune(golden_corpus())
    cfg = apply_to_serve_config(art, ServeConfig(batch_size=4))
    assert cfg.batch_size == 4
    assert [list(b) for b in cfg.buckets] == art["buckets"]
    joint = apply_to_model_config(art, JointConfig().small)
    assert joint.gnn.routing == tuple((cap, mode) for cap, mode in art["routing"])
    assert apply_to_model_config(art, GraphSAGEConfig()).routing == joint.gnn.routing
    bare = build_artifact(((256, 512, 64),), (), {}, {})
    assert apply_to_model_config(bare, JointConfig().small) == JointConfig().small


def test_tuned_rungs_are_inside_the_kernels_limits():
    width = max(GraphSAGEConfig().hidden, 24)
    for n, e, _s in apply_to_serve_config(tune(golden_corpus())).buckets:
        assert kernels.rung_limits(n, e, width, ServeConfig().batch_size)["ok"]


def test_rejected_windows_flow_into_corpus_and_demand(tmp_path):
    from nerrf_tpu_torch.archive import ArchiveConfig, ArchiveWriter, export_tune

    w = ArchiveWriter(ArchiveConfig(out_dir=str(tmp_path / "arch")))
    for _ in range(4):
        w.observe_window("1024n/2048e/128s", nodes=300, edges=600, files=20,
                         stages={"device": 0.01}, e2e_sec=0.05)
    w.observe_rejected(nodes=9000, edges=20000, files=600)
    w.close()
    corpus = export_tune(str(tmp_path / "arch"))
    assert corpus["windows_rejected"] == 1
    assert corpus["rejected_window_size_distribution"] is not None
    assert any(p.nodes > 4096 for p in demand_points(corpus))


def test_build_artifact_fingerprints_corpus():
    c = golden_corpus()
    a = build_artifact(((256, 512, 64),), ((256, "fused"),),
                       {"improvement": 0.0}, {}, corpus=c)
    b = build_artifact(((256, 512, 64),), ((256, "fused"),),
                       {"improvement": 0.0}, {},
                       corpus=dict(c, windows_observed=101))
    assert a["corpus_fingerprint"] != b["corpus_fingerprint"]
    assert a == jtune.build_artifact(((256, 512, 64),), ((256, "fused"),),
                                     {"improvement": 0.0}, {}, corpus=c)


def test_save_artifact_atomic_under_crash(tmp_path, monkeypatch):
    from nerrf_tpu_torch.tune import artifact as am

    path = tmp_path / "tuned.json"
    art = tune(golden_corpus())
    save_artifact(path, art)
    real_write = am.Path.write_text

    def crashing_write(self, text, *a, **kw):
        if self.name.endswith(".tmp"):
            real_write(self, text[: len(text) // 2], *a, **kw)
            raise OSError("disk full mid-publish")
        return real_write(self, text, *a, **kw)

    monkeypatch.setattr(am.Path, "write_text", crashing_write)
    newer = dict(art, corpus_fingerprint="f" * 16)
    with pytest.raises(OSError):
        save_artifact(path, newer)
    monkeypatch.undo()
    assert load_artifact(path) == art
    save_artifact(path, newer)
    assert load_artifact(path) == newer
