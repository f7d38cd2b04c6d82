"""The port's out-of-process agent (``repro_torch.launch.agent_main``) on
the CPU: its JSON-line protocol over TCP on ``127.0.0.1``, served from a
thread by ``main`` itself (port 0: the operating system picks a free one).
"""
import json
import socket
import socketserver
import threading
import time

import pytest

from repro.launch.agent_main import make_agent as ref_make_agent
from repro_torch.launch import agent_main

TIMEOUT_S = 120.0


class _Client:
    def __init__(self, address):
        self.sock = socket.create_connection(address, timeout=TIMEOUT_S)
        self.rfile = self.sock.makefile("rb")

    def call(self, msg):
        self.sock.sendall((json.dumps(msg) + "\n").encode())
        return json.loads(self.rfile.readline())

    def close(self):
        self.rfile.close()
        self.sock.close()


@pytest.fixture
def served(monkeypatch, tmp_path):
    """``agent_main.main`` on port 0 with ``--device cpu`` and a registry
    file, in a daemon thread; yields (address, registry file, tick) and
    shuts the server down after the test.  The heartbeat thread's sleep
    waits for ``tick.release()``, so a test decides when it renews the
    lease (and it renews nothing once the test is over)."""
    started, servers, tick = threading.Event(), [], threading.Semaphore(0)

    class _Clock:
        @staticmethod
        def sleep(seconds):
            tick.acquire()

    monkeypatch.setattr(agent_main, "time", _Clock)

    class Recorded(socketserver.ThreadingTCPServer):
        daemon_threads = True

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)
            started.set()

    monkeypatch.setattr(agent_main.socketserver, "ThreadingTCPServer", Recorded)
    registry_file = str(tmp_path / "registry.json")
    thread = threading.Thread(target=agent_main.main, daemon=True, args=(
        ["--port", "0", "--device", "cpu", "--registry-file", registry_file],))
    thread.start()
    assert started.wait(TIMEOUT_S), "the agent did not start"
    (srv,) = servers
    try:
        yield srv.server_address, registry_file, tick
    finally:
        srv.shutdown()
        thread.join(TIMEOUT_S)
    assert not thread.is_alive()


def test_agent_answers_the_protocol(served):
    address, _, _ = served
    client = _Client(address)
    try:
        info = client.call({"method": "Info"})
        assert info["ok"] and info["result"]["backend"] == "torch"
        assert info["result"]["agent_id"].startswith("torch-")
        ref = ref_make_agent("ref")
        assert info["result"]["models"] == sorted(ref.manifests)
        assert "resnet50:1.5.0" in info["result"]["models"]

        request = {"model": "mamba2-130m", "backend": "torch", "trace_level": "MODEL",
                   "seq_len": 8, "scenario": {"kind": "online", "num_requests": 2,
                                              "rate_hz": 1000.0, "warmup": 0}}
        res = client.call({"method": "Predict", "params": {"request": request}})
        assert res["ok"], res
        metrics = res["result"]["metrics"]
        assert metrics["num_requests"] == 2 and metrics["trimmed_mean_ms"] > 0
        assert res["result"]["model"] == "mamba2-130m:1.0.0"

        assert client.call({"method": "Heartbeat"}) == {"ok": True}
        bad = client.call({"method": "Open"})
        assert bad == {"ok": False, "error": "unknown method 'Open'"}
        failed = client.call({"method": "Predict", "params": {"request": {"model": "nope"}}})
        assert failed["ok"] is False and "nope" in failed["error"]

        assert client.call({"method": "Close"}) == {"ok": True}
        assert client.rfile.readline() == b""          # the agent ended the connection
    finally:
        client.close()


def test_agent_writes_and_renews_its_registry_lease_file(served):
    address, registry_file, tick = served

    def read():
        with open(registry_file) as f:
            return json.load(f)

    first = read()
    (agent_key,) = [k for k in first if k.startswith("agents/torch-")]
    assert first[agent_key]["value"]["backend"] == "torch"
    assert first[agent_key]["value"]["system"]["platform"] == "cpu"
    assert "manifests/resnet50:1.5.0" in first and "manifests/mamba2-130m:1.0.0" in first
    expires = first[agent_key]["expires_at"]
    tick.release()                                  # one heartbeat: renew, dump
    deadline = time.monotonic() + TIMEOUT_S
    while read()[agent_key]["expires_at"] == expires:
        assert time.monotonic() < deadline, "the heartbeat did not renew the lease"
        time.sleep(0.01)
    assert read()[agent_key]["expires_at"] > expires


def test_agent_runs_on_the_card_unless_asked():
    import torch

    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        agent_main.make_agent("torch")
