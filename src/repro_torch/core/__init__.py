"""MLModelScope core of the PyTorch port: the paper's primary contribution.

The port's copy of ``repro.core`` (same subsystems, names and exports), over
the ``torch`` predictor:

* :mod:`.manifest`   — benchmarking specification, versioning [F1, F2, F5]
* :mod:`.registry`   — distributed registry, agent resolution [F4, F5]
* :mod:`.predictor`  — 3-function predictor interface [F2, F3]
* :mod:`.pipeline`   — streaming evaluation pipeline [F6]
* :mod:`.scenarios`  — benchmarking scenarios [F7]
* :mod:`.workload`   — pluggable request-load generators [F7]
* :mod:`.analysis`   — automated analysis & reporting [F8]
* :mod:`.tracing`    — across-stack tracing [F9]
* :mod:`.evaldb`     — evaluation database [F4, F8]
* :mod:`.agent`      — evaluation agents [F2, F4]
* :mod:`.server`     — dispatch, failover, straggler mitigation [F4]
* :mod:`.platform`   — the single-host wiring; :mod:`.client` its CLI
"""
from ..serve.scheduler import RequestScheduler, SchedulerConfig, SchedulerQueueFull
from .agent import Agent, DataManager, EvaluationRequest
from .analysis import (
    latency_summary,
    percentile,
    scheduler_summary,
    slo_attainment,
    throughput_scalability,
    top_layers,
    trimmed_mean,
)
from .evaldb import EvalDB, EvaluationRecord
from .manifest import (
    BackendManifest,
    ModelManifest,
    SystemRequirements,
    VersionConstraint,
)
from .pipeline import Pipeline, build_steps, register_op
from .predictor import (
    CallablePredictor,
    OpenRequest,
    Predictor,
    PredictorHandle,
    available_backends,
    make_predictor,
    register_predictor,
)
from .registry import AgentRecord, KVStore, Registry
from .scenarios import (
    Scenario,
    ScenarioSpec,
    make_scenario,
    register_scenario,
    run_scenario,
    scenario_kinds,
)
from .server import DispatchError, DispatchPolicy, Server
from .tracing import NullTracer, Span, Tracer, TraceLevel, TracingServer
from .workload import (
    BatchedLoad,
    PoissonLoad,
    Request,
    TraceReplayLoad,
    UniformLoad,
    make_generator,
    register_generator,
)

__all__ = [
    "Agent",
    "AgentRecord",
    "BackendManifest",
    "BatchedLoad",
    "CallablePredictor",
    "DataManager",
    "DispatchError",
    "DispatchPolicy",
    "EvalDB",
    "EvaluationRecord",
    "EvaluationRequest",
    "KVStore",
    "ModelManifest",
    "NullTracer",
    "OpenRequest",
    "Pipeline",
    "PoissonLoad",
    "Predictor",
    "PredictorHandle",
    "Registry",
    "Request",
    "RequestScheduler",
    "Scenario",
    "ScenarioSpec",
    "SchedulerConfig",
    "SchedulerQueueFull",
    "Server",
    "Span",
    "SystemRequirements",
    "TraceLevel",
    "TraceReplayLoad",
    "Tracer",
    "TracingServer",
    "UniformLoad",
    "VersionConstraint",
    "available_backends",
    "build_steps",
    "latency_summary",
    "make_generator",
    "make_predictor",
    "make_scenario",
    "percentile",
    "register_generator",
    "register_op",
    "register_predictor",
    "register_scenario",
    "run_scenario",
    "scenario_kinds",
    "scheduler_summary",
    "slo_attainment",
    "throughput_scalability",
    "top_layers",
    "trimmed_mean",
]
