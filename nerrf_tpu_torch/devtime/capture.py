"""Profiler capture plane: torch.profiler traces on demand and on breach.

The port of ``nerrf_tpu/devtime/capture.py``: `profiled`, `capture_trace`
and `trace_summary` over `observability.trace_profile`, with the
reference's production contracts:

  * fail-open — a profiler that cannot start (another session active, an
    unwritable dir) journals a ``profile_failed`` record and the caller
    proceeds; evidence capture must never take the serving plane down.
    This is the reference's semantics for evidence, not a device
    fallback: the work being watched runs where it runs either way;
  * every successful capture journals a ``profile_capture`` record with
    the trace dir and file count, so bundles and ``doctor`` can find it;
  * `capture_trace` is the timed form (capture whatever the process's
    threads and the card do for N seconds) used by the flight recorder's
    opt-in p99-breach action and ``profile capture``.

A trace is one Chrome-trace JSON file (``*.pt.trace.json``, loadable in
Perfetto and TensorBoard); `trace_summary` gives offline readers
(``doctor``) the inventory without parsing it, and imports no torch.

PyTorch has no profiler server like the reference's
``jax.profiler.start_server``; `ProfilerServer` is its counterpart, a small
HTTP endpoint in the serving process (``GET /capture?seconds=S``), and
`fetch_capture` the client ``profile capture --target`` uses.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


def _count_trace_files(log_dir: str) -> tuple:
    files = 0
    size = 0
    for root, _dirs, names in os.walk(log_dir):
        for name in names:
            files += 1
            try:
                size += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return files, size


@contextlib.contextmanager
def profiled(log_dir, enabled: bool = True, journal=None):
    """Fail-open profiling region around `observability.trace_profile`.

    Yields the trace dir (str) while capturing, or None when disabled or
    the profiler could not start — callers never branch on profiler
    health.  Start/stop failures journal ``profile_failed``; a completed
    capture journals ``profile_capture`` with the file inventory."""
    if not enabled:
        yield None
        return
    if journal is None:
        from nerrf_tpu_torch.flight.journal import DEFAULT_JOURNAL

        journal = DEFAULT_JOURNAL
    from nerrf_tpu_torch.observability import trace_profile

    log_dir = os.fspath(log_dir)
    cm = trace_profile(log_dir)
    try:
        cm.__enter__()
    except Exception as e:  # noqa: BLE001 — fail-open: no trace, no crash
        journal.record("profile_failed", dir=log_dir, phase="start",
                       error=f"{type(e).__name__}: {e}")
        yield None
        return
    try:
        yield log_dir
    finally:
        try:
            cm.__exit__(None, None, None)
        except Exception as e:  # noqa: BLE001 — stop failure is fail-open too
            journal.record("profile_failed", dir=log_dir, phase="stop",
                           error=f"{type(e).__name__}: {e}")
        else:
            files, size = _count_trace_files(log_dir)
            journal.record("profile_capture", dir=log_dir, files=files,
                           bytes=size)


def capture_trace(log_dir, seconds: float = 1.0, enabled: bool = True,
                  journal=None) -> Optional[str]:
    """Capture ``seconds`` of whatever this process's threads and the card
    are doing (the scorer keeps scoring while the profiler watches) into
    ``log_dir``.  Returns the dir on success, None when disabled or the
    capture failed (fail-open, journaled)."""
    with profiled(log_dir, enabled=enabled, journal=journal) as active:
        if active is None:
            return None
        deadline = time.monotonic() + max(float(seconds), 0.0)
        while time.monotonic() < deadline:
            time.sleep(min(0.05, max(deadline - time.monotonic(), 0.0)))
    files, _ = _count_trace_files(log_dir)
    return log_dir if files else None


def trace_summary(log_dir) -> Optional[dict]:
    """Offline inventory of a capture dir (the ``doctor`` surface):
    {"files": N, "bytes": B} or None when the dir is absent/empty."""
    log_dir = os.fspath(log_dir)
    if not os.path.isdir(log_dir):
        return None
    files, size = _count_trace_files(log_dir)
    if not files:
        return None
    return {"files": files, "bytes": size}


class ProfilerServer:
    """The serving process's capture endpoint (``serve-detect
    --profiler-port``), the counterpart of the reference's jax.profiler
    server, which PyTorch has none of.  ``GET /capture?seconds=S`` runs
    `capture_trace` for S seconds in this process (the scorer keeps
    scoring while the profiler watches) and answers with the trace file
    (``application/json``, its name in ``Content-Disposition``); 503 when
    the capture failed (another profiler session active, journaled as
    ``profile_failed``), 400 for a ``seconds`` outside (0, 60], 404
    elsewhere.  Stdlib HTTP on a daemon thread; one capture at a time."""

    MAX_SECONDS = 60.0

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 journal=None) -> None:
        import http.server
        import shutil
        import tempfile
        import threading
        import urllib.parse

        from nerrf_tpu_torch.observability import load_profiler

        load_profiler()
        server = self
        self._journal = journal
        self._busy = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib API)
                url = urllib.parse.urlparse(self.path)
                if url.path != "/capture":
                    return self._send(404, b"not found\n", "text/plain")
                query = urllib.parse.parse_qs(url.query)
                try:
                    seconds = float(query.get("seconds", ["1"])[0])
                except ValueError:
                    seconds = -1.0
                if not 0 < seconds <= server.MAX_SECONDS:
                    return self._send(
                        400, b"seconds must lie in (0, 60]\n", "text/plain")
                with server._busy:
                    tmp = tempfile.mkdtemp(prefix="nerrf-capture-")
                    try:
                        got = capture_trace(tmp, seconds=seconds,
                                            journal=server._journal)
                        names = sorted(os.listdir(tmp)) if got else []
                        if not names:
                            return self._send(
                                503, b"profiler capture failed\n",
                                "text/plain")
                        with open(os.path.join(tmp, names[0]), "rb") as f:
                            body = f.read()
                    finally:
                        shutil.rmtree(tmp, ignore_errors=True)
                self._send(200, body, "application/json",
                           {"Content-Disposition":
                            f'attachment; filename="{names[0]}"'})

            def _send(self, code, body, ctype, headers=None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:  # silence per-request spam
                del args

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="nerrf-profiler-server",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "ProfilerServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def fetch_capture(target: str, seconds: float, out_dir) -> str:
    """Ask a `ProfilerServer` at ``target`` (``host:port``) for a capture of
    ``seconds`` and write the trace file it answers with into ``out_dir``;
    returns the file's path.  Raises OSError (an HTTP error status
    included) or ValueError (a malformed target)."""
    import re
    import urllib.request

    host, _, port = target.rpartition(":")
    url = f"http://{host or '127.0.0.1'}:{int(port)}/capture?seconds={seconds}"
    with urllib.request.urlopen(url, timeout=float(seconds) + 60.0) as resp:
        body = resp.read()
        disp = resp.headers.get("Content-Disposition") or ""
    m = re.search(r'filename="([^"/]+)"', disp)
    name = m.group(1) if m else "capture.pt.trace.json"
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(os.fspath(out_dir), name)
    with open(path, "wb") as f:
        f.write(body)
    return path
