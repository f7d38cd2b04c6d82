"""Subprocess agent: one MLModelScope agent per process over a JSON-line
socket protocol (the offline stand-in for the paper's gRPC agent service).

The port's copy of ``repro.launch.agent_main`` over the port's
:class:`~repro_torch.core.agent.Agent`: the same protocol, the same reduced
built-in manifests, the ``torch`` backend by default, and ``--device``
(``cuda`` unless given; ``cpu`` runs the plain path).

Protocol (newline-delimited JSON over TCP):

    -> {"method": "Predict", "params": {"request": {...EvaluationRequest...}}}
    <- {"ok": true, "result": {...metrics...}}
    -> {"method": "Heartbeat"}
    <- {"ok": true}
    -> {"method": "Info"}
    <- {"ok": true, "result": {"agent_id": ..., "backend": ..., "models": [...]}}
    -> {"method": "Close"}
    <- {"ok": true}                       (and the connection ends)

Any other method, or a request that fails, answers ``{"ok": false,
"error": ...}``.  With ``--registry-file`` the agent loads and dumps its
registry there, and a heartbeat thread renews its lease file every third of
``Registry.AGENT_TTL`` so the server can detect a dead agent.

    PYTHONPATH=src python -m repro_torch.launch.agent_main --port 7071 --device cpu
"""
from __future__ import annotations

import argparse
import json
import socketserver
import threading
import time
from typing import Optional

from ..core.agent import Agent, EvaluationRequest
from ..core.evaldb import EvalDB
from ..core.platform import builtin_manifests
from ..core.registry import KVStore, Registry
from ..core.tracing import TracingServer


def make_agent(backend: str, registry_file: str = "", device: Optional[str] = None) -> Agent:
    store = KVStore()
    if registry_file:
        try:
            store.load(registry_file)
        except FileNotFoundError:
            pass
    registry = Registry(store)
    agent = Agent(
        backend=backend,
        registry=registry,
        tracing_server=TracingServer(),
        evaldb=EvalDB(),
        device=device,
    )
    agent.register_models(builtin_manifests(reduced=True))
    if registry_file:
        store.dump(registry_file)

        def heartbeat() -> None:
            while True:
                time.sleep(Registry.AGENT_TTL / 3)
                agent.heartbeat()
                store.dump(registry_file)

        threading.Thread(target=heartbeat, daemon=True).start()
    return agent


class Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        agent: Agent = self.server.agent  # type: ignore[attr-defined]
        for line in self.rfile:
            try:
                msg = json.loads(line)
                method = msg.get("method")
                if method == "Predict":
                    req = EvaluationRequest.from_dict(msg["params"]["request"])
                    result = agent.evaluate(req)
                    resp = {"ok": True, "result": result}
                elif method == "Heartbeat":
                    resp = {"ok": agent.heartbeat()}
                elif method == "Info":
                    resp = {"ok": True, "result": {
                        "agent_id": agent.agent_id,
                        "backend": agent.backend,
                        "models": sorted(agent.manifests),
                    }}
                elif method == "Close":
                    resp = {"ok": True}
                    self.wfile.write((json.dumps(resp) + "\n").encode())
                    return
                else:
                    resp = {"ok": False, "error": f"unknown method {method!r}"}
            except Exception as e:  # noqa: BLE001 - the agent answers every request
                resp = {"ok": False, "error": str(e)}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7071)
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--registry-file", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain path)")
    args = ap.parse_args(argv)
    agent = make_agent(args.backend, args.registry_file, args.device)
    with socketserver.ThreadingTCPServer((args.host, args.port), Handler) as srv:
        srv.agent = agent  # type: ignore[attr-defined]
        print(f"[agent] {agent.agent_id} serving on {args.host}:{args.port}")
        srv.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
