"""Serve replicas as managed processes (docs/fleet.md).

Two halves in one module:

  * The MANAGER half (`ReplicaProcess`, `ReplicaSet`) — spawn / drain /
    stop `OnlineDetectionService` replicas as child processes and
    actuate the fleet controller's decisions on them.  Each replica is
    ``python -m nerrf_tpu_torch.fleet.replica``: a JSON-line command protocol
    on stdin/stdout (assign/unassign/stats/parity/stop) plus the
    standard serve observability surface over HTTP (/metrics, /healthz,
    /readyz) — the controller scrapes replicas exactly as Prometheus
    would, nothing is read through a side channel.
  * The CHILD half (`main`) — one serve replica on ``--device`` (the
    card unless ``--device cpu``; without CUDA it raises): the real
    `OnlineDetectionService` behind a `MetricsServer`, fed by paced
    synthetic streams (the multi-process test substrate the fleet bench
    soaks).  With ``--synthetic-cost`` the device program is a
    deterministic sleep-per-real-window scorer (the capacity ramp's
    known-cost device: it launches no kernel), so saturation points are
    analytic and the autoscaling / shedding gates are exact instead of
    host-speed-dependent.  The port has no compile cache yet (ROADMAP
    A.7): ``--compile-cache`` exits 2, and every bucket warms live.

The port of ``nerrf_tpu/fleet/replica.py``.  Its ``stats`` reply adds
``launches``, the child's own kernel launch counters
(`nerrf_tpu_torch.ops.LAUNCHES`), which no other process can read.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import select
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Dict, List, Optional

COMPILE_CACHE_REFUSAL = ("fleet --compile-cache needs the compile cache, "
                         "which is not ported yet (ROADMAP A.7)")

# -- manager half -------------------------------------------------------------


class ReplicaProcess:
    """One spawned replica: command channel + observability endpoints.

    The child prints exactly one JSON line per command (and one hello
    line at boot carrying the bound metrics port), so the channel is a
    strict request/response alternation — no framing, no partial
    reads."""

    def __init__(self, name: str, args=(), env: Optional[dict] = None,
                 python: str = sys.executable,
                 boot_timeout: float = 180.0,
                 log=lambda *a: None) -> None:
        self.name = name
        self._log = log
        self._lock = threading.Lock()
        cmd = [python, "-m", "nerrf_tpu_torch.fleet.replica", *map(str, args)]
        self.proc = subprocess.Popen(
            cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, env={**os.environ, **(env or {})})
        hello = self._read(timeout=boot_timeout)
        if not hello.get("ok"):
            raise RuntimeError(f"replica {name} failed to boot: {hello}")
        self.port = int(hello["port"])
        self.pid = self.proc.pid

    def _read(self, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"replica {self.name}: no response in {timeout}s")
            r, _, _ = select.select([self.proc.stdout], [], [],
                                    min(left, 1.0))
            if not r:
                if self.proc.poll() is not None:
                    raise RuntimeError(
                        f"replica {self.name} exited "
                        f"rc={self.proc.returncode}")
                continue
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(
                    f"replica {self.name} closed stdout "
                    f"(rc={self.proc.poll()})")
            try:
                return json.loads(line)
            except ValueError:
                continue  # stray non-JSON line: keep waiting

    def cmd(self, op: str, timeout: float = 60.0, **kw) -> dict:
        with self._lock:
            self.proc.stdin.write(json.dumps({"op": op, **kw}) + "\n")
            self.proc.stdin.flush()
            return self._read(timeout=timeout)

    # observability endpoints — scraped exactly as Prometheus/K8s would

    def scrape(self, timeout: float = 5.0) -> Optional[str]:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/metrics",
                    timeout=timeout) as resp:
                return resp.read().decode()
        except Exception:  # noqa: BLE001 — a scrape miss is data
            return None

    def ready(self, timeout: float = 5.0) -> bool:
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/readyz",
                    timeout=timeout) as resp:
                return resp.status == 200
        except Exception:  # noqa: BLE001
            return False

    def stop(self, timeout: float = 120.0) -> Optional[dict]:
        """Drain and stop: the child finishes in-flight windows, closes
        its planes, answers with final stats and exits."""
        stats = None
        try:
            stats = self.cmd("stop", timeout=timeout)
        except Exception as e:  # noqa: BLE001 — always reap below
            self._log(f"[fleet] replica {self.name} stop: {e}")
        try:
            self.proc.wait(timeout=30.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10.0)
        return stats


class ReplicaSet:
    """The controller's actuation surface over `ReplicaProcess`es: the
    five-method pool protocol (replicas/streams/scale_out/scale_in/
    apply_slots) plus the bench-facing stream registry."""

    def __init__(self, spawn, max_replicas: int = 4,
                 log=lambda *a: None) -> None:
        self._spawn = spawn  # Callable[[name], ReplicaProcess]
        self.max_replicas = max_replicas
        self._log = log
        self._lock = threading.Lock()
        self._reps: Dict[str, ReplicaProcess] = {}
        self._streams: Dict[str, float] = {}  # base stream → rate_hz
        self._where: Dict[str, str] = {}      # base stream → replica
        self._seq = 0
        self._closed = False

    # -- pool protocol (fleet/controller.py) ----------------------------------

    def replicas(self) -> Dict[str, ReplicaProcess]:
        with self._lock:
            return dict(self._reps)

    def streams(self) -> List[str]:
        with self._lock:
            return sorted(self._streams)

    def scale_out(self) -> Optional[str]:
        with self._lock:
            if self._closed or len(self._reps) >= self.max_replicas:
                return None
            name = f"r{self._seq}"
            self._seq += 1
        rep = self._spawn(name)  # slow (process boot): outside the lock
        with self._lock:
            # re-validate closed too: a spawn in flight when stop_all()
            # drained the set must not be adopted into the empty pool —
            # it would outlive the manager as an orphan child
            if not self._closed and len(self._reps) < self.max_replicas:  # nerrflint: ok[atomicity-violation] benign split: the spawn must run unlocked (process boot is seconds) and the cap is re-validated on this exact line under the lock — a racing scale_out that filled the last slot makes this one stop its fresh replica below
                self._reps[name] = rep
                return name
        rep.stop()
        return None

    def scale_in(self, name: str) -> None:
        with self._lock:
            rep = self._reps.pop(name, None)
            orphaned = [s for s, r in self._where.items() if r == name]
            for s in orphaned:
                del self._where[s]  # next apply_slots re-places them
        if rep is not None:
            rep.stop()

    def apply_slots(self, mapping: Dict[str, str], moved) -> None:
        del moved  # the journal record is the controller's; we actuate
        with self._lock:
            reps = dict(self._reps)
            work = []
            for s, target in mapping.items():
                cur = self._where.get(s)
                if cur == target or target not in reps:
                    continue
                work.append((s, cur, target, self._streams.get(s)))
                self._where[s] = target
            gone = [(s, r) for s, r in self._where.items()
                    if s not in mapping]
            for s, _r in gone:
                del self._where[s]
        for s, cur, target, rate in work:
            if cur in reps:
                reps[cur].cmd("unassign", stream=s)
            if rate is not None:
                reps[target].cmd("assign", stream=s, rate_hz=rate)
        for s, r in gone:
            if r in reps:
                reps[r].cmd("unassign", stream=s)

    # -- bench-facing stream registry -----------------------------------------

    def add_stream(self, stream: str, rate_hz: float) -> None:
        with self._lock:
            self._streams[stream] = float(rate_hz)

    def remove_stream(self, stream: str) -> None:
        with self._lock:
            self._streams.pop(stream, None)
            rep_name = self._where.pop(stream, None)
            rep = self._reps.get(rep_name) if rep_name else None
        if rep is not None:
            rep.cmd("unassign", stream=stream)

    def stop_all(self) -> Dict[str, Optional[dict]]:
        with self._lock:
            self._closed = True  # late in-flight spawns self-stop
            reps = dict(self._reps)
            self._reps.clear()
            self._where.clear()
        return {name: rep.stop() for name, rep in sorted(reps.items())}


def replica_args(metrics_port: int = 0, buckets: str = "256x512x64",
                 batch_size: int = 8, close_ms: float = 50.0,
                 deadline_sec: float = 2.0, queue_slots: int = 64,
                 window_sec: float = 15.0, stride_sec: float = 5.0,
                 synthetic_cost: float = 0.0,
                 shed_margin: float = 1.0,
                 devtime_window_sec: float = 60.0,
                 compile_cache: Optional[str] = None,
                 archive_dir: Optional[str] = None,
                 snapshot_sec: float = 30.0,
                 device: str = "cuda") -> List[str]:
    """The child argv for one replica spec — kept next to `main`'s
    parser so the two cannot drift."""
    args = ["--metrics-port", metrics_port, "--buckets", buckets,
            "--batch-size", batch_size, "--close-ms", close_ms,
            "--deadline-sec", deadline_sec, "--queue-slots", queue_slots,
            "--window-sec", window_sec, "--stride-sec", stride_sec,
            "--synthetic-cost", synthetic_cost,
            "--shed-margin", shed_margin,
            "--devtime-window-sec", devtime_window_sec,
            "--snapshot-sec", snapshot_sec, "--device", device]
    if compile_cache:
        args += ["--compile-cache", compile_cache]
    if archive_dir:
        args += ["--archive-dir", archive_dir]
    return [str(a) for a in args]


# -- child half ---------------------------------------------------------------


class _Feeder:
    """Paced synthetic stream: one simulated trace fed stride-by-stride
    so each feed closes ~one window, at ``rate_hz`` windows/s.  When the
    trace runs out it cycles with the timestamps advanced (the windower
    needs monotonic time).  NON-daemon + stop event + bounded join —
    the repo's thread-lifecycle discipline."""

    def __init__(self, svc, stream: str, rate_hz: float,
                 window_sec: float, stride_sec: float,
                 events_hz: float = 12.0) -> None:
        import numpy as np

        from nerrf_tpu_torch.data.synth import SimConfig, simulate_trace

        self.svc = svc
        self.stream = stream
        self.rate_hz = max(float(rate_hz), 0.1)
        seed = sum(stream.encode()) % 9973
        # events_hz sets window DENSITY (distinct nodes/edges per
        # window), independent of rate_hz (windows per second): a dense
        # stream's windows climb the bucket ladder, which is how the
        # fleet bench builds a physically expensive budget-burner
        self.trace = simulate_trace(SimConfig(
            duration_sec=max(window_sec * 8, 60.0), attack=False,
            num_target_files=4, benign_rate_hz=float(events_hz),
            seed=seed))
        ev = self.trace.events
        ts = ev.ts_ns
        stride_ns = int(stride_sec * 1e9)
        t0, t1 = int(ts.min()), int(ts.max())
        self.blocks = []
        for lo in range(t0, t1 + 1, stride_ns):
            m = (ts >= lo) & (ts < lo + stride_ns)
            if not m.any():
                continue
            self.blocks.append(type(ev)(**{
                f.name: getattr(ev, f.name)[m]
                for f in dataclasses.fields(ev)}))
        self.span_ns = (t1 - t0) + stride_ns
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=False,
            name=f"nerrf-fleet-feed-{stream}")
        del np

    def start(self) -> "_Feeder":
        self.svc.join(self.stream)
        self._thread.start()
        return self

    def _run(self) -> None:
        off = 0
        interval = 1.0 / self.rate_hz
        nxt = time.monotonic()
        while not self._stop.is_set():
            for block in self.blocks:
                if self._stop.is_set():
                    return
                shifted = dataclasses.replace(
                    block, ts_ns=block.ts_ns + off)
                try:
                    self.svc.feed(self.stream, shifted,
                                  self.trace.strings)
                except (RuntimeError, KeyError):
                    return  # stream left / service stopping
                nxt += interval
                lag = nxt - time.monotonic()
                if lag > 0:
                    self._stop.wait(lag)
            off += self.span_ns

    def stop(self, leave: bool = True) -> None:
        self._stop.set()
        self._thread.join(timeout=30.0)
        if leave:
            try:
                self.svc.leave(self.stream, flush=False, timeout=15.0)
            except (RuntimeError, KeyError):
                pass


def _build_service(args, registry, journal):
    """One replica's service: the real OnlineDetectionService over the
    seeded small model on ``args.device``, with the device program
    optionally replaced by the deterministic known-cost sleeper
    (--synthetic-cost) — every host-side plane (admission, batching, SLO,
    headroom, shedding, archive) is the production code either way."""
    import numpy as np

    from nerrf_tpu_torch.models import JointConfig, build_nerrfnet
    from nerrf_tpu_torch.serve import OnlineDetectionService, ServeConfig

    buckets = tuple(tuple(int(x) for x in spec.split("x"))
                    for spec in args.buckets.split(","))
    cfg = ServeConfig(
        buckets=buckets, batch_size=args.batch_size,
        batch_close_sec=args.close_ms / 1000.0,
        window_deadline_sec=args.deadline_sec,
        stream_queue_slots=args.queue_slots,
        window_sec=args.window_sec, stride_sec=args.stride_sec,
        shed_headroom_margin=args.shed_margin,
        devtime_window_sec=args.devtime_window_sec,
        quality_monitoring=False)
    # the seeded counterpart of the reference's init_untrained_params
    model = build_nerrfnet(JointConfig().small, seed=0, device=args.device)

    if args.synthetic_cost > 0:

        class KnownCostService(OnlineDetectionService):
            """Deterministic device: sleeps --synthetic-cost seconds per
            REAL window in the batch, scaled by the batch's bucket size
            (node capacity relative to the 256 rung — a bigger graph
            costs proportionally more device time, as it does live), and
            scores zeros.  No forward and no launch at all, so the ramp's
            saturation point is analytic: 1/(rate_hz × cost) streams on
            the 256 rung."""

            def _run_eval(self, eval_fn, batch):
                del eval_fn
                mask = np.asarray(batch["node_mask"])
                occ = int(mask.any(axis=1).sum())
                time.sleep(args.synthetic_cost * occ
                           * (mask.shape[1] / 256.0))
                return {"node_logit": np.zeros(mask.shape, np.float32)}

        service_cls = KnownCostService
    else:
        service_cls = OnlineDetectionService
    svc = service_cls(model, cfg=cfg, registry=registry, journal=journal,
                      device=args.device)
    return svc, cfg, model


def _stats(svc, cfg, registry, journal) -> dict:
    from nerrf_tpu_torch.ops import LAUNCHES
    from nerrf_tpu_torch.serve import bucket_tag

    est = None
    if svc.devtime is not None and svc.devtime.last_estimate is not None:
        est = svc.devtime.last_estimate.to_dict()
    tags = [bucket_tag(b) for b in cfg.buckets]
    slo = svc.slo.snapshot()
    return {
        "ok": True,
        "ready": bool(svc.ready()[0]),
        # the SLO tracker observes every window at demux — its per-stream
        # counts ARE the delivered-window ledger
        "windows_scored": int(sum(
            ent.get("count", 0)
            for ent in (slo.get("per_stream") or {}).values())),
        "windows_admitted": int(registry.value(
            "serve_windows_admitted_total")),
        "dropped": {reason: int(registry.value(
            "serve_admission_dropped_total", labels={"reason": reason}))
            for reason in ("backpressure", "shed", "oversize", "leave",
                           "closed", "quarantined")},
        "recompiles_after_warmup": int(sum(
            registry.value("serve_recompiles_total",
                           labels={"bucket": t}) for t in tags)),
        # every warmed bucket ran live: the reference's provenance without
        # a compile cache
        "warmup_source": {tag: "live" for tag in svc.warmup_seconds},
        "headroom": est,
        "slo": slo,
        "shed_records": [r.to_dict() for r in journal.tail()
                         if r.kind == "fleet_shed"],
        "launches": dict(LAUNCHES),
    }


def parity_trace():
    """The simulated trace the ``parity`` op replays."""
    from nerrf_tpu_torch.data.synth import SimConfig, simulate_trace

    return simulate_trace(SimConfig(
        duration_sec=60.0, attack=True, attack_start_sec=20.0,
        num_target_files=4, benign_rate_hz=6.0, seed=4242))


def _parity(svc, cfg, model, stream: str, device) -> dict:
    """The acceptance-criterion leg, in-replica: one simulated trace
    through join→feed→leave must be bit-identical to the offline
    `model_detect` at the same bucket/weights (auto_capacity=False)."""
    from nerrf_tpu_torch.pipeline import model_detect

    tr = parity_trace()
    ev = tr.events
    svc.join(stream)
    for i in range(0, len(ev.ts_ns), 200):
        block = type(ev)(**{f.name: getattr(ev, f.name)[i:i + 200]
                            for f in dataclasses.fields(ev)})
        svc.feed(stream, block, tr.strings)
    served = svc.leave(stream, flush=True, timeout=120.0)
    offline = model_detect(
        dataclasses.replace(tr, name=stream), model,
        ds_cfg=cfg.dataset_config(cfg.buckets[0]),
        auto_capacity=False, batch_size=cfg.batch_size, device=device)
    parity = (
        served.file_scores == offline.file_scores
        and served.file_window_scores == offline.file_window_scores
        and served.proc_scores == offline.proc_scores
        and served.file_bytes == offline.file_bytes
        and served.threshold == offline.threshold)
    return {"ok": True, "parity": bool(parity),
            "windows": len(served.file_window_scores or {})}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="one fleet serve replica (JSON commands on stdin)")
    p.add_argument("--metrics-port", type=int, default=0)
    p.add_argument("--buckets", default="256x512x64")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--close-ms", type=float, default=50.0)
    p.add_argument("--deadline-sec", type=float, default=2.0)
    p.add_argument("--queue-slots", type=int, default=64)
    p.add_argument("--window-sec", type=float, default=15.0)
    p.add_argument("--stride-sec", type=float, default=5.0)
    p.add_argument("--synthetic-cost", type=float, default=0.0)
    p.add_argument("--shed-margin", type=float, default=1.0)
    p.add_argument("--devtime-window-sec", type=float, default=60.0)
    p.add_argument("--compile-cache", default=None,
                   help="not ported yet (ROADMAP A.7), exits 2")
    p.add_argument("--archive-dir", default=None)
    p.add_argument("--snapshot-sec", type=float, default=30.0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where tensors live (default: the card; 'cpu' runs "
                        "the kernels' plain versions); without CUDA the "
                        "default raises")
    args = p.parse_args(argv)
    if args.compile_cache is not None:
        print(COMPILE_CACHE_REFUSAL, file=sys.stderr, flush=True)
        return 2

    from nerrf_tpu_torch.device import resolve_device
    from nerrf_tpu_torch.flight.journal import EventJournal
    from nerrf_tpu_torch.observability import MetricsRegistry, MetricsServer

    device = resolve_device(args.device)
    registry = MetricsRegistry()
    journal = EventJournal(registry=registry)
    svc, cfg, model = _build_service(args, registry, journal)
    archive = None
    if args.archive_dir:
        from nerrf_tpu_torch.archive import ArchiveConfig, ArchiveWriter

        archive = ArchiveWriter(
            ArchiveConfig(out_dir=args.archive_dir,
                          snapshot_every_sec=args.snapshot_sec),
            registry=registry, journal=journal)
        svc.attach_archive(archive)
    svc.start(log=lambda *a: print(*a, file=sys.stderr, flush=True))
    metrics = MetricsServer(registry=registry, host="127.0.0.1",
                            port=args.metrics_port,
                            ready_check=svc.ready)

    def reply(obj: dict) -> None:
        sys.stdout.write(json.dumps(obj) + "\n")
        sys.stdout.flush()

    reply({"ok": True, "port": metrics.port, "pid": os.getpid()})
    feeders: Dict[str, _Feeder] = {}
    rc = 0
    try:
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except ValueError:
                reply({"ok": False, "error": "bad json"})
                continue
            op = msg.get("op")
            try:
                if op == "ping":
                    reply({"ok": True, "ready": bool(svc.ready()[0])})
                elif op == "assign":
                    s = msg["stream"]
                    if s in feeders:  # rate update = replace
                        feeders.pop(s).stop()
                    feeders[s] = _Feeder(
                        svc, s, msg.get("rate_hz", 1.0),
                        cfg.window_sec, cfg.stride_sec,
                        events_hz=msg.get("events_hz", 12.0)).start()
                    reply({"ok": True, "stream": s})
                elif op == "unassign":
                    s = msg["stream"]
                    f = feeders.pop(s, None)
                    if f is not None:
                        f.stop()
                    reply({"ok": True, "stream": s})
                elif op == "stats":
                    reply(_stats(svc, cfg, registry, journal))
                elif op == "parity":
                    reply(_parity(svc, cfg, model,
                                  msg.get("stream", "parity"), device))
                elif op == "stop":
                    break
                else:
                    reply({"ok": False, "error": f"unknown op {op!r}"})
            except Exception as e:  # noqa: BLE001 — protocol stays up
                reply({"ok": False,
                       "error": f"{type(e).__name__}: {e}"})
    finally:
        for f in feeders.values():
            f.stop()
        final = _stats(svc, cfg, registry, journal)
        svc.stop(drain=True)
        if archive is not None:
            archive.close()
        metrics.close()
        try:
            reply(final)
        except (BrokenPipeError, OSError):
            # manager already gone (killed, or we arrived here via stdin
            # EOF after it exited): the final stats have nowhere to go —
            # exit clean instead of dying in the reply
            pass
    return rc


if __name__ == "__main__":
    sys.exit(main())
