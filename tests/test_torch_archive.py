"""The port's telemetry archive (nerrf_tpu_torch.archive) against the JAX
package's, on the CPU.

* Host copies (``archive/spool.py``, ``archive/writer.py``,
  ``archive/report.py``): the source is the reference's.
* Across packages: an archive the reference's `ArchiveWriter` wrote reads
  the same through the port's `verify_archive`, `build_report`,
  `export_tune` and `report_main` as through the reference's, and the other
  way round; `prune_archive`, `merge_archives` and `compare_reports` give
  the same results.
* Serve: a service with the archive attached spools every scored window,
  and the report counts the windows served.
* The command line: ``archive ls|verify|prune|merge|export`` and ``report``.
"""

import contextlib
import io
import json
import pathlib

import numpy as np
import pytest

from nerrf_tpu import archive as jarchive
from nerrf_tpu.flight import journal as jjournal
from nerrf_tpu.observability import MetricsRegistry as JMetricsRegistry
from nerrf_tpu_torch import archive, cli
from nerrf_tpu_torch.data import SimConfig, simulate_trace
from nerrf_tpu_torch.flight import journal
from nerrf_tpu_torch.observability import MetricsRegistry
from nerrf_tpu_torch.serve import MicroBatcher, OnlineDetectionService, ServeConfig
from nerrf_tpu_torch.serve import init_untrained_model
from nerrf_tpu_torch.models import JointConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
BUCKET = (128, 256, 32)
BUCKETS = ["256n/512e/64s", "1024n/2048e/128s"]


@pytest.mark.parametrize("rel", ["archive/spool.py", "archive/writer.py",
                                 "archive/report.py"])
def test_host_copies_are_the_references_source(rel):
    text = (ROOT / "nerrf_tpu_torch" / rel).read_text()
    text = text.replace(f"\nA host copy of ``nerrf_tpu/{rel}``, kept identical.\n", "")
    assert text.replace("nerrf_tpu_torch.", "nerrf_tpu.") == \
        (ROOT / "nerrf_tpu" / rel).read_text()


def _drive(pkg, jmod, reg_cls, out_dir, seed):
    """Feed one writer of ``pkg`` seeded journal records and windows, then
    close it (the final snapshot pair and the sealed tail)."""
    reg = reg_cls(namespace="t")
    jr = jmod.EventJournal(registry=reg)
    w = pkg.ArchiveWriter(pkg.ArchiveConfig(out_dir=str(out_dir),
                                            segment_max_bytes=4096),
                          registry=reg, journal=jr)
    rng = np.random.default_rng(seed)
    for i in range(60):
        bucket = BUCKETS[i % 2]
        jr.record("batch_close", bucket=bucket, occupancy=int(rng.integers(1, 9)))
        stages = {k: float(v) for k, v in zip(("queue", "pack", "device", "demux"),
                                               rng.exponential(0.01, 4))}
        w.observe_window(bucket, nodes=int(rng.integers(10, 900)),
                         edges=int(rng.integers(10, 2000)),
                         files=int(rng.integers(1, 60)), stages=stages,
                         e2e_sec=sum(stages.values()))
        reg.counter_inc("serve_windows_scored_total")
        if i % 17 == 0:
            jr.record("admission_drop", stream=f"s{i % 3}", reason="oversize")
            w.observe_rejected(nodes=5000, edges=9000, files=300)
    w.close()
    return w


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("arc")
    _drive(jarchive, jjournal, JMetricsRegistry, tmp / "ref", seed=1)
    _drive(archive, journal, MetricsRegistry, tmp / "port", seed=2)
    return tmp


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_readers_agree_on_either_packages_archive(archives, writer):
    d = archives / writer
    assert len(archive.list_segments(d)) > 1  # rotation at 4 KiB
    assert archive.list_segments(d) == jarchive.list_segments(d)
    assert archive.is_archive_dir(d) and jarchive.is_archive_dir(d)
    assert archive.verify_archive(d) == jarchive.verify_archive(d)
    assert archive.verify_archive(d)["ok"]
    got, want = archive.build_report([str(d)]), jarchive.build_report([str(d)])
    assert got == want
    assert got["slo"]["windows_scored"] == 60
    assert archive.format_report(got) == jarchive.format_report(want)
    assert archive.export_tune([str(d)]) == jarchive.export_tune([str(d)])
    assert list(archive.iter_records([str(d)])) == list(jarchive.iter_records([str(d)]))
    outs = []
    for main in (archive.report_main, jarchive.report_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([str(d)], as_json=True)
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1] and outs[0][0] == 0


def test_compare_prune_and_merge_match_the_reference(archives, tmp_path):
    ref, port = str(archives / "ref"), str(archives / "port")
    a, b = archive.build_report([ref]), archive.build_report([port])
    cfg, jcfg = archive.CompareConfig(), jarchive.CompareConfig()
    assert cfg.to_dict() == jcfg.to_dict()
    assert archive.compare_reports(a, b, cfg) == jarchive.compare_reports(a, b, jcfg)
    assert archive.format_compare(archive.compare_reports(a, b, cfg)) == \
        jarchive.format_compare(jarchive.compare_reports(a, b, jcfg))
    merged = {}
    for name, pkg in (("port", archive), ("ref", jarchive)):
        out = tmp_path / f"merged-{name}"
        res = pkg.merge_archives([ref, port], str(out))
        merged[name] = (res["records"], list(pkg.iter_records([str(out)])))
    assert merged["port"] == merged["ref"]
    for name, pkg in (("port", archive), ("ref", jarchive)):
        for src in ("ref", "port"):
            d = tmp_path / f"prune-{name}-{src}"
            jarchive.merge_archives([str(archives / src)], str(d))
            res = pkg.prune_archive(str(d), 3000)
            assert res.pop("dir") == str(d)
            merged[f"prune-{name}-{src}"] = res
    assert merged["prune-port-ref"] == merged["prune-ref-ref"]
    assert merged["prune-port-port"] == merged["prune-ref-port"]


def test_serve_spools_every_scored_window(tmp_path):
    cfg = ServeConfig(buckets=(BUCKET,), batch_size=4, window_sec=15.0,
                      stride_sec=5.0)
    reg = MetricsRegistry(namespace="t")
    jr = journal.EventJournal(registry=reg)
    svc = OnlineDetectionService(
        init_untrained_model(JointConfig().small, cfg, device="cpu"), cfg,
        registry=reg, journal=jr, device="cpu")
    # a stub scorer: the archive's seams are admission and demux
    svc._batcher = MicroBatcher(
        score_fn=lambda b: np.full(b["node_mask"].shape, 0.9), cfg=cfg,
        registry=reg, on_scored=svc._on_scored, on_failed=svc._on_failed,
        journal=jr)
    svc._batcher.mark_warm(BUCKET)
    w = archive.ArchiveWriter(archive.ArchiveConfig(out_dir=str(tmp_path / "a")),
                              registry=reg, journal=jr)
    svc.attach_archive(w)
    svc._batcher.start()
    svc._admission_open = True
    tr = simulate_trace(SimConfig(duration_sec=60.0, attack=True, attack_start_sec=20.0,
                                  num_target_files=6, benign_rate_hz=6.0, seed=3))
    big = simulate_trace(SimConfig(duration_sec=60.0, attack=True, attack_start_sec=20.0,
                                   num_target_files=6, benign_rate_hz=20.0, seed=4))
    try:
        svc.join("s0")
        svc.feed("s0", tr.events, tr.strings)
        svc.leave("s0", timeout=30.0)
        svc.join("big")  # windows past the one bucket: rejected, sketched
        svc.feed("big", big.events, big.strings)
        svc.leave("big", timeout=30.0)
    finally:
        svc.stop()
        w.close()
    served = reg.value("serve_windows_scored_total")
    rejected = reg.value("serve_admission_dropped_total", labels={"reason": "oversize"})
    assert served > 0 and rejected > 0
    assert archive.verify_archive(tmp_path / "a")["ok"]
    rep = archive.build_report([str(tmp_path / "a")])
    assert rep == jarchive.build_report([str(tmp_path / "a")])
    assert rep["slo"]["windows_scored"] == served
    tune = archive.export_tune([str(tmp_path / "a")])
    assert tune["windows_observed"] == served
    assert tune["windows_rejected"] == rejected


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("argv,rc", [
    (["archive", "ls", "{ref}"], 0),
    (["archive", "verify", "{ref}", "--json"], 0),
    (["archive", "merge", "{ref}", "{port}", "--out", "{tmp}/m"], 0),
    (["archive", "prune", "{tmp}/m", "--max-bytes", "5000"], 0),
    (["archive", "export", "{ref}", "--tune", "--out", "{tmp}/tune.json"], 0),
    (["archive", "export", "{tmp}/empty"], 1),
    (["archive", "verify", "{tmp}/nowhere"], 2),
    (["report", "{ref}", "{port}"], 0),
    (["report", "--compare", "{ref}", "{port}", "--json"], None),
], ids=["ls", "verify", "merge", "prune", "export", "export-empty", "verify-missing",
        "report", "report-compare"])
def test_archive_and_report_commands(archives, tmp_path, argv, rc):
    (tmp_path / "empty").mkdir()
    if "{tmp}/m" in argv and argv[1] == "prune":
        jarchive.merge_archives([str(archives / "ref")], str(tmp_path / "m"))
    fill = dict(ref=archives / "ref", port=archives / "port", tmp=tmp_path)
    argv = [a.format(**fill) for a in argv]
    got, out, err = _run(argv)
    if rc is None:  # --compare: exit 0 or 1 by the verdict, as the reference's
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            want = jarchive.report_main(None, compare=argv[2:4], as_json=True)
        assert (got, out) == (want, buf.getvalue())
        assert json.loads(out)["regressions"] is not None
        return
    assert got == rc, err
    if argv[1] == "ls":
        assert out.splitlines()[-1].endswith("bytes")
    if argv[1] == "export" and rc == 0:
        assert json.loads((tmp_path / "tune.json").read_text()) == \
            jarchive.export_tune(str(archives / "ref"))
