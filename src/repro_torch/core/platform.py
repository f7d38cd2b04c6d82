"""Platform bootstrap: wire registry + server + agents + model zoo.

``LocalPlatform`` is the single-host instantiation of the paper's
deployment: one server, N agents (one per backend/"stack"), shared
middleware (registry, tracing server, evaluation DB).  The built-in model
manifests are registered at agent initialization, mirroring workflow step 0.

The port's copy of ``repro.core.platform``: its manifests are the
reference's, entry for entry (the architectures of
``repro_torch.configs.list_archs``, then ResNet-50 with its image
pipeline); its agents run the ``torch`` backend on one device, ``cuda``
unless the caller asks for the CPU.  The port keeps its own copy so that
it never imports ``repro``.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from .agent import Agent, EvaluationRequest
from .evaldb import EvalDB
from .manifest import IOSpec, ModelManifest, ProcessingStep
from .registry import Registry
from .server import Server
from .tracing import TracingServer


def builtin_manifests(reduced: bool = True) -> List[ModelManifest]:
    """Model manifests for the architecture zoo (+ the paper's ResNet-50),
    as the reference writes them."""
    from ..configs import get_config, list_archs

    manifests = []
    for arch in list_archs():
        cfg = get_config(arch, reduced=reduced)
        manifests.append(
            ModelManifest(
                name=arch,
                version="1.0.0",
                description=f"{cfg.family} LM ({arch})",
                arch=arch,
                reduced=reduced,
                inputs=[IOSpec(type="tokens", element_type="int32")],
                outputs=[IOSpec(type="logits", element_type="float32")],
                model_assets={"seed": 0},
                attributes={
                    "family": cfg.family,
                    "vocab_size": cfg.vocab_size,
                    "params": cfg.param_count(),
                    "params_active": cfg.param_count(active_only=True),
                },
            )
        )
    manifests.append(
        ModelManifest(
            name="resnet50",
            version="1.5.0",
            description="ResNet-50 v1.5 (MLPerf reference; the paper's workload)",
            arch="resnet50",
            reduced=reduced,
            inputs=[
                IOSpec(
                    type="image",
                    element_type="float32",
                    steps=[
                        ProcessingStep("decode", {"element_type": "float32"}),
                        ProcessingStep(
                            "resize", {"dimensions": [3, 32 if reduced else 224, 32 if reduced else 224]}
                        ),
                        ProcessingStep(
                            "normalize",
                            {"mean": [123.68, 116.78, 103.94], "rescale": 255.0},
                        ),
                    ],
                )
            ],
            outputs=[
                IOSpec(
                    type="probability",
                    element_type="float32",
                    steps=[ProcessingStep("argsort", {"k": 5})],
                )
            ],
            model_assets={"seed": 0},
            attributes={"family": "vision"},
        )
    )
    return manifests


class LocalPlatform:
    """A fully-wired single-host MLModelScope instance."""

    def __init__(
        self,
        backends: Iterable[str] = ("torch",),
        evaldb_path: str = ":memory:",
        reduced_models: bool = True,
        device: Optional[str] = None,
    ) -> None:
        self.registry = Registry()
        self.tracing_server = TracingServer()
        self.evaldb = EvalDB(evaldb_path)
        self.server = Server(self.registry, self.tracing_server, self.evaldb)
        self.agents: Dict[str, Agent] = {}
        manifests = builtin_manifests(reduced=reduced_models)
        for backend in backends:
            agent = Agent(
                backend=backend,
                registry=self.registry,
                tracing_server=self.tracing_server,
                evaldb=self.evaldb,
                lease_ttl=3600.0,   # in-process: alive as long as the process
                device=device,
            )
            agent.register_models(manifests)
            self.server.attach_agent(agent)
            self.agents[agent.agent_id] = agent

    def evaluate(self, req: EvaluationRequest, **kw):
        return self.server.evaluate(req, **kw)

    def analyze(self, **kw):
        return self.server.analyze(**kw)

    def report(self, **kw) -> str:
        return self.server.report(**kw)

    def shutdown(self) -> None:
        for agent in self.agents.values():
            agent.shutdown()
        self.server.shutdown()
        self.evaldb.close()
