"""The port's Firecracker API client (nerrf_tpu_torch.rollback.fc) against a
fake unix-socket Firecracker, on each of its engines: the reference's
workflow sequence, an HTTP error surfaced, a connect failure.  The native
engine is ``libnerrf_fcdriver.so`` built into the port's own directory; the
Python engine's request bytes equal the reference's Python engine's on the
same calls, and both read the same answers back."""

import http.server
import json
import socket
import socketserver
import threading

import pytest

from nerrf_tpu.rollback import fc as jfc
from nerrf_tpu_torch.rollback.fc import FirecrackerAPI, _py_request, fc_native_available

ENGINES = ["python"] + (["native"] if fc_native_available() else [])


class _FakeFirecracker:
    """Unix-socket HTTP server recording the API calls it receives."""

    def __init__(self, sock_path):
        self.calls = []
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _record(self, method):
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length).decode() if length else ""
                outer.calls.append(
                    (method, self.path, json.loads(body) if body else None))

            def _reply(self, status, payload=b""):
                self.send_response(status)
                if payload:
                    self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.send_header("Connection", "close")
                self.end_headers()
                if payload:
                    self.wfile.write(payload)

            def do_GET(self):  # noqa: N802
                self._record("GET")
                self._reply(200, json.dumps(
                    {"id": "fake-fc", "state": "Running",
                     "vmm_version": "1.0-fake"}).encode())

            def do_PUT(self):  # noqa: N802
                self._record("PUT")
                if self.path == "/bad":
                    self._reply(400, b'{"fault_message": "nope"}')
                else:
                    self._reply(204)

            def do_PATCH(self):  # noqa: N802
                self._record("PATCH")
                self._reply(204)

            def log_message(self, *a):
                del a

        class Server(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
            daemon_threads = True

            def get_request(self):
                request, _ = super().get_request()
                # BaseHTTPRequestHandler wants a (host, port)-ish client addr
                return request, ("127.0.0.1", 0)

        self.server = Server(str(sock_path), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def fake_fc(tmp_path):
    sock = tmp_path / "fc.sock"
    srv = _FakeFirecracker(sock)
    yield sock, srv
    srv.close()


@pytest.mark.parametrize("engine", ENGINES)
def test_workflow_sequence(fake_fc, engine):
    sock, srv = fake_fc
    api = FirecrackerAPI(str(sock), use_native=(engine == "native"))
    assert api.is_native == (engine == "native")
    info = api.describe()
    assert info["id"] == "fake-fc"
    api.configure_machine(vcpus=2, mem_mib=512)
    api.set_boot_source("/img/vmlinux")
    api.add_drive("rootfs", "/img/rootfs.ext4", root=True)
    api.start()
    api.pause()
    api.snapshot("/snap/vmstate", "/snap/mem")

    methods = [(m, p) for m, p, _ in srv.calls]
    assert methods == [
        ("GET", "/"),
        ("PUT", "/machine-config"),
        ("PUT", "/boot-source"),
        ("PUT", "/drives/rootfs"),
        ("PUT", "/actions"),
        ("PATCH", "/vm"),
        ("PUT", "/snapshot/create"),
    ]
    bodies = {p: b for _, p, b in srv.calls if b}
    assert bodies["/machine-config"] == {"vcpu_count": 2, "mem_size_mib": 512}
    assert bodies["/drives/rootfs"]["is_root_device"] is True
    assert bodies["/actions"] == {"action_type": "InstanceStart"}


@pytest.mark.parametrize("engine", ENGINES)
def test_api_error_is_surfaced(fake_fc, engine):
    sock, _ = fake_fc
    api = FirecrackerAPI(str(sock), use_native=(engine == "native"))
    with pytest.raises(RuntimeError, match="HTTP 400"):
        api._expect("PUT", "/bad", {"x": 1})


@pytest.mark.parametrize("engine", ENGINES)
def test_connect_failure(tmp_path, engine):
    api = FirecrackerAPI(str(tmp_path / "absent.sock"),
                         use_native=(engine == "native"))
    with pytest.raises(OSError):
        api.request("GET", "/")


class _RawRecorder:
    """A unix socket that keeps each connection's request bytes and answers
    each with one fixed response."""

    def __init__(self, path, response: bytes):
        self.requests = []
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.bind(str(path))
        self.sock.listen(8)
        self.response = response
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                raw = b""
                while b"\r\n\r\n" not in raw:
                    raw += conn.recv(4096)
                head, _, body = raw.partition(b"\r\n\r\n")
                for line in head.split(b"\r\n"):
                    if line.lower().startswith(b"content-length:"):
                        want = int(line.split(b":", 1)[1])
                        while len(body) < want:
                            body += conn.recv(4096)
                self.requests.append(raw[:len(head) + 4] + body)
                conn.sendall(self.response)

    def close(self):
        self.sock.close()


CALLS = [("GET", "/", None),
         ("PUT", "/machine-config", {"vcpu_count": 2, "mem_size_mib": 512}),
         ("PATCH", "/vm", {"state": "Paused"}),
         ("PUT", "/drives/rootfs", {"drive_id": "rootfs", "path_on_host": "/ü/r.ext4",
                                    "is_root_device": True, "is_read_only": False})]
RESPONSES = {
    "length": b"HTTP/1.1 200 OK\r\nContent-Length: 17\r\n\r\n{\"state\": \"ok\"} \n",
    "empty": b"HTTP/1.1 204 No Content\r\n\r\n",
    "chunked": (b"HTTP/1.1 200 OK\r\nTransfer-Encoding: chunked\r\n\r\n"
                b"5\r\n{\"a\":\r\n3\r\n 1}\r\n0\r\n\r\n"),
}


@pytest.mark.parametrize("response", sorted(RESPONSES))
def test_python_engine_bytes_are_the_references(tmp_path, response):
    got = {}
    for name, request in (("port", _py_request), ("ref", jfc._py_request)):
        rec = _RawRecorder(tmp_path / f"{name}.sock", RESPONSES[response])
        try:
            answers = [request(str(tmp_path / f"{name}.sock"), m, p,
                               json.dumps(b) if b is not None else None, 2000)
                       for m, p, b in CALLS]
        finally:
            rec.close()
        got[name] = (rec.requests, answers)
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == len(CALLS)
