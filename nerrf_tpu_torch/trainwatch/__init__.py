"""trainwatch: the training run's health plane.

In-step telemetry computed on the card inside the train step
(`telemetry.step_telemetry`), a `TrainHealthMonitor` exporting
``nerrf_train_*`` gauges and cadenced ``train_health`` journal records and
firing train-side flight triggers (``train_divergence`` /
``train_starvation`` / ``train_stall``) through a `FlightRecorder`.

`training_health` is the one wiring point the CLIs and `run_experiment`
share, the reference's (``nerrf_tpu/trainwatch/__init__.py``): it builds
the monitor, the train-aware ``/readyz`` metrics server, the flight
recorder and the telemetry archive from three flags (``--metrics-port`` /
``--flight-dir`` / ``--archive-dir``) and tears everything down in order on
exit.
"""

from __future__ import annotations

import contextlib

from nerrf_tpu_torch.trainwatch.monitor import TrainHealthConfig, TrainHealthMonitor
from nerrf_tpu_torch.trainwatch.telemetry import (
    global_norm,
    nonfinite_count,
    step_telemetry,
)

__all__ = [
    "TrainHealthConfig",
    "TrainHealthMonitor",
    "global_norm",
    "nonfinite_count",
    "step_telemetry",
    "training_health",
]


@contextlib.contextmanager
def training_health(metrics_port=None, flight_dir=None, archive_dir=None,
                    cfg=None, registry=None, journal=None, log=None):
    """Wire the training-health plane for one run; yields the monitor
    (None when every surface is disabled — the loop then pays nothing).

    * ``metrics_port`` ≥ 0 → a `MetricsServer` with the train-aware
      ``ready_check`` (503 before the first step and after a
      divergence halt);
    * ``flight_dir`` set → a `FlightRecorder` whose ``info()`` is the
      monitor's run identity; train triggers dump bundles there;
    * ``archive_dir`` set → a telemetry `ArchiveWriter`: the run's journal
      stream (train_start / train_health / train_done, exceptions),
      cadenced metrics snapshots and the train-step workload sketch spool
      to crash-safe segments `nerrf report` reads offline.  Bundles dumped
      by the recorder carry the archive position in their manifest.

    Teardown order matters and is owned here: monitor thread first (it
    may fire into the recorder), then the recorder's journal
    subscription, then the archive writer (it seals the tail), then the
    HTTP server.
    """
    if (metrics_port is None or metrics_port < 0) and not flight_dir \
            and not archive_dir:
        yield None
        return
    monitor = TrainHealthMonitor(cfg, registry=registry, journal=journal,
                                 log=log)
    recorder = None
    server = None
    archive = None
    try:
        if archive_dir:
            from nerrf_tpu_torch.archive import ArchiveConfig, ArchiveWriter

            archive = ArchiveWriter(ArchiveConfig(out_dir=str(archive_dir)),
                                    registry=registry, journal=journal,
                                    log=log)
            if log:
                log(f"trainwatch: telemetry archive spooling to "
                    f"{archive_dir}")
        if flight_dir:
            from nerrf_tpu_torch.flight import FlightConfig, FlightRecorder

            recorder = FlightRecorder(
                FlightConfig(out_dir=str(flight_dir)),
                registry=registry, journal=journal,
                info=monitor.flight_info, archive=archive, log=log)
            monitor.attach_flight(recorder)
            if log:
                log(f"trainwatch: flight recorder armed, bundles in "
                    f"{flight_dir}")
        if metrics_port is not None and metrics_port >= 0:
            from nerrf_tpu_torch.observability import MetricsServer

            server = MetricsServer(registry=registry, host="0.0.0.0",
                                   port=metrics_port,
                                   ready_check=monitor.ready)
            if log:
                log(f"trainwatch: metrics on :{server.port} "
                    f"(/metrics, /healthz, /readyz)")
        monitor.start()
        yield monitor
    finally:
        monitor.stop()
        if recorder is not None:
            recorder.close()
        if archive is not None:
            archive.close()
        if server is not None:
            server.close()
