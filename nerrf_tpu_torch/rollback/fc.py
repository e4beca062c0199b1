"""Firecracker API client: native C++ transport + microVM sandbox workflow.

Transport is `libnerrf_fcdriver.so` (HTTP/1.1 over the Firecracker Unix API
socket, native/src/fcdriver.cc) with a Python-socket fallback implementing
the same framing.  The workflow methods map 1:1 onto the API calls the
reference's sandbox spec needs (upstream NERRF's
`docs/content/docs/architecture.mdx:75-87`): configure boot source +
rootfs drive, start the microVM, pause, snapshot — the
clone→replay→verify loop drives these on a KVM host.

The client is fully testable without KVM: any HTTP server on a Unix socket
(tests use a stdlib ThreadingHTTPServer) stands in for Firecracker.

The port of ``nerrf_tpu/rollback/fc.py``: the library is built into the
port's own ``ops/_build/native/`` (`ingest.bridge.load_native_lib`), and
the engine is the caller's ``use_native`` (None: native when the library
builds); the reference's ``NERRF_NO_NATIVE`` variable is not read.
"""

from __future__ import annotations

import ctypes
import json
import socket
from typing import Optional, Tuple

from nerrf_tpu_torch.ingest.bridge import load_native_lib

_LIB_NAME = "libnerrf_fcdriver.so"
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False

_ERRORS = {-1: "connect failed", -2: "send failed",
           -3: "malformed response", -4: "timeout"}


def fc_native_available() -> bool:
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        lib = load_native_lib(_LIB_NAME)
        if lib is not None:
            lib.nerrf_fc_request.restype = ctypes.c_int
            lib.nerrf_fc_request.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_int,
            ]
            _LIB = lib
    return _LIB is not None


def _py_request(socket_path: str, method: str, path: str,
                body: Optional[str], timeout_ms: int) -> Tuple[int, str]:
    """Fallback transport: same request framing as the native driver."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout_ms / 1000.0)
        s.connect(socket_path)
        payload = (body or "").encode()
        head = (
            f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
            "Accept: application/json\r\n"
        )
        if payload:
            head += ("Content-Type: application/json\r\n"
                     f"Content-Length: {len(payload)}\r\n")
        head += "Connection: close\r\n\r\n"
        s.sendall(head.encode() + payload)
        # read to completion by Content-Length when advertised (Firecracker
        # keeps connections alive — EOF-only framing would stall to timeout)
        raw = b""
        content_length = None
        hdr_end = -1
        while len(raw) < (1 << 20):
            chunk = s.recv(4096)
            if not chunk:
                break
            raw += chunk
            if hdr_end < 0:
                hdr_end = raw.find(b"\r\n\r\n")
                if hdr_end >= 0:
                    hdr = raw[:hdr_end].lower()
                    idx = hdr.find(b"content-length:")
                    if idx >= 0:
                        content_length = int(
                            hdr[idx + 15:].split(b"\r\n", 1)[0])
                    elif b"transfer-encoding: chunked" not in hdr:
                        content_length = 0  # no body advertised (e.g. 204)
            if (hdr_end >= 0 and content_length is not None
                    and len(raw) - (hdr_end + 4) >= content_length):
                break
    header, _, rest = raw.partition(b"\r\n\r\n")
    status_line = header.split(b"\r\n", 1)[0].split()
    if len(status_line) < 2 or not status_line[0].startswith(b"HTTP/"):
        raise OSError("malformed response")
    status = int(status_line[1])
    if b"transfer-encoding: chunked" in header.lower():
        joined, pos = b"", 0
        while pos < len(rest):
            eol = rest.find(b"\r\n", pos)
            if eol < 0:
                break
            size = int(rest[pos:eol] or b"0", 16)
            if size <= 0:
                break
            joined += rest[eol + 2:eol + 2 + size]
            pos = eol + 2 + size + 2
        rest = joined
    return status, rest.decode("utf-8", "replace")


class FirecrackerAPI:
    """One microVM's API socket."""

    def __init__(self, socket_path: str, timeout_ms: int = 5000,
                 use_native: Optional[bool] = None) -> None:
        self.socket_path = socket_path
        self.timeout_ms = timeout_ms
        if use_native is None:
            use_native = fc_native_available()
        elif use_native and not fc_native_available():
            raise RuntimeError(f"{_LIB_NAME} not available")
        self._native = bool(use_native)

    @property
    def is_native(self) -> bool:
        return self._native

    def request(self, method: str, path: str,
                body: Optional[dict] = None) -> Tuple[int, dict]:
        text = json.dumps(body) if body is not None else None
        if self._native:
            buf = ctypes.create_string_buffer(1 << 20)
            status = _LIB.nerrf_fc_request(
                self.socket_path.encode(), method.encode(), path.encode(),
                text.encode() if text is not None else None,
                buf, len(buf), self.timeout_ms,
            )
            if status < 0:
                raise OSError(f"fc request {method} {path}: "
                              f"{_ERRORS.get(status, status)}")
            payload = buf.value.decode("utf-8", "replace")
        else:
            status, payload = _py_request(
                self.socket_path, method, path, text, self.timeout_ms)
        data = json.loads(payload) if payload.strip() else {}
        return status, data

    def _expect(self, method: str, path: str, body: Optional[dict],
                ok=(200, 204)) -> dict:
        status, data = self.request(method, path, body)
        if status not in ok:
            raise RuntimeError(
                f"{method} {path} -> HTTP {status}: {data}")
        return data

    # --- the sandbox workflow (architecture.mdx:79-86) ----------------------

    def describe(self) -> dict:
        return self._expect("GET", "/", None)

    def configure_machine(self, vcpus: int = 1, mem_mib: int = 256) -> None:
        self._expect("PUT", "/machine-config",
                     {"vcpu_count": vcpus, "mem_size_mib": mem_mib})

    def set_boot_source(self, kernel_image: str,
                        boot_args: str = "console=ttyS0 reboot=k panic=1") -> None:
        self._expect("PUT", "/boot-source",
                     {"kernel_image_path": kernel_image, "boot_args": boot_args})

    def add_drive(self, drive_id: str, path: str, root: bool = False,
                  read_only: bool = False) -> None:
        self._expect("PUT", f"/drives/{drive_id}",
                     {"drive_id": drive_id, "path_on_host": path,
                      "is_root_device": root, "is_read_only": read_only})

    def start(self) -> None:
        self._expect("PUT", "/actions", {"action_type": "InstanceStart"})

    def pause(self) -> None:
        self._expect("PATCH", "/vm", {"state": "Paused"})

    def resume(self) -> None:
        self._expect("PATCH", "/vm", {"state": "Resumed"})

    def snapshot(self, snapshot_path: str, mem_file_path: str) -> None:
        self._expect("PUT", "/snapshot/create",
                     {"snapshot_type": "Full", "snapshot_path": snapshot_path,
                      "mem_file_path": mem_file_path})
