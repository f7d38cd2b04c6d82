"""Benchmarking specification (paper F1/F2/F5, §4.1).

MLModelScope defines all four aspects of an evaluation — model, software
stack, system, benchmarking scenario — in textual manifests so the platform
can *provision* a reproducible evaluation. We keep the paper's YAML schema
(Listing 1 & 2) and adapt the fields to the JAX/TPU world:

* model manifest     — names an architecture config + shapes + processing
                       steps + asset (checkpoint) references with checksums.
* backend manifest   — the "framework manifest" analogue: names a compute
                       backend (``ref`` | ``pallas``), its version constraint,
                       and the mesh stacks it provides (the paper's per-arch
                       docker containers become per-topology mesh specs).

Version constraints use the paper's ``'>=1.12.0 <2.0'`` syntax.

The port's copy of ``repro.core.manifest``.  PyYAML is imported only by the
YAML readers and writers (and ``checksum``), which the evaluation path never
calls.  Every module of ``repro_torch`` keeps its own copy of what it needs
so that it never imports ``repro``.
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

def _yaml():
    """PyYAML, imported at first use: only the YAML readers and writers
    (and ``checksum``) need it, and the evaluation path calls none of them."""
    import yaml

    return yaml


# --------------------------------------------------------------------------
# Semantic versions + constraints (F5 artifact versioning)
# --------------------------------------------------------------------------
_VER_RE = re.compile(r"^(\d+)(?:\.(\d+))?(?:\.(\d+))?$")
_CONS_RE = re.compile(r"(>=|<=|==|>|<|~)?\s*(\d+(?:\.\d+){0,2})")


def parse_version(text: str) -> Tuple[int, int, int]:
    m = _VER_RE.match(str(text).strip())
    if not m:
        raise ValueError(f"invalid semantic version: {text!r}")
    major, minor, patch = (int(g) if g else 0 for g in m.groups())
    return (major, minor, patch)


class VersionConstraint:
    """A conjunction of comparator clauses, e.g. ``'>=1.12.0 <2.0'``."""

    def __init__(self, spec: str = "") -> None:
        self.spec = str(spec or "").strip()
        self.clauses: List[Tuple[str, Tuple[int, int, int]]] = []
        if self.spec:
            for op, ver in _CONS_RE.findall(self.spec):
                self.clauses.append((op or "==", parse_version(ver)))

    def satisfied_by(self, version: str) -> bool:
        v = parse_version(version)
        for op, ref in self.clauses:
            ok = {
                "==": v == ref,
                ">=": v >= ref,
                "<=": v <= ref,
                ">": v > ref,
                "<": v < ref,
                "~": v[:2] == ref[:2],  # compatible-release on major.minor
            }[op]
            if not ok:
                return False
        return True

    def __repr__(self) -> str:  # pragma: no cover
        return f"VersionConstraint({self.spec!r})"


# --------------------------------------------------------------------------
# Processing steps (built-in pipeline operators, §4.1.1)
# --------------------------------------------------------------------------
@dataclass
class ProcessingStep:
    """One built-in pre/post-processing pipeline operator."""

    op: str
    params: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_entry(cls, entry: Any) -> "ProcessingStep":
        if isinstance(entry, str):
            return cls(op=entry)
        if isinstance(entry, dict) and len(entry) == 1:
            (op, params), = entry.items()
            return cls(op=op, params=dict(params or {}))
        raise ValueError(f"invalid processing step: {entry!r}")


@dataclass
class IOSpec:
    """One input/output modality (type + layer name + element type + steps)."""

    type: str
    layer_name: str = ""
    element_type: str = "float32"
    steps: List[ProcessingStep] = field(default_factory=list)


# --------------------------------------------------------------------------
# Model manifest (Listing 1)
# --------------------------------------------------------------------------
@dataclass
class ModelManifest:
    name: str
    version: str = "1.0.0"
    description: str = ""
    backend_name: str = "ref"                # paper: framework.name
    backend_constraint: str = ""             # paper: framework.version
    arch: str = ""                           # architecture config id
    reduced: bool = False                    # use the smoke-scale config
    inputs: List[IOSpec] = field(default_factory=list)
    outputs: List[IOSpec] = field(default_factory=list)
    model_assets: Dict[str, Any] = field(default_factory=dict)  # checkpoint dir, checksum, seed
    attributes: Dict[str, Any] = field(default_factory=dict)

    # -- construction ----------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ModelManifest":
        fw = d.get("framework", d.get("backend", {})) or {}
        def _iospecs(key: str) -> List[IOSpec]:
            specs = []
            for e in d.get(key, []) or []:
                specs.append(
                    IOSpec(
                        type=e.get("type", "tensor"),
                        layer_name=e.get("layer_name", ""),
                        element_type=e.get("element_type", "float32"),
                        steps=[ProcessingStep.from_entry(s) for s in e.get("steps", []) or []],
                    )
                )
            return specs

        m = cls(
            name=d["name"],
            version=str(d.get("version", "1.0.0")),
            description=d.get("description", ""),
            backend_name=fw.get("name", "ref"),
            backend_constraint=str(fw.get("version", "")),
            arch=d.get("arch", d.get("model", {}).get("arch", "")) or "",
            reduced=bool(d.get("reduced", False)),
            inputs=_iospecs("inputs"),
            outputs=_iospecs("outputs"),
            model_assets=dict(d.get("model", {}) or {}),
            attributes=dict(d.get("attributes", {}) or {}),
        )
        m.validate()
        return m

    @classmethod
    def from_yaml(cls, text: str) -> "ModelManifest":
        return cls.from_dict(_yaml().safe_load(text))

    @classmethod
    def load(cls, path: str) -> "ModelManifest":
        with open(path) as f:
            return cls.from_yaml(f.read())

    # -- serialization (round-trip for the registry) ----------------------
    def to_dict(self) -> Dict[str, Any]:
        def _io(specs: Sequence[IOSpec]) -> List[Dict[str, Any]]:
            return [
                {
                    "type": s.type,
                    "layer_name": s.layer_name,
                    "element_type": s.element_type,
                    "steps": [{p.op: p.params} for p in s.steps],
                }
                for s in specs
            ]

        return {
            "name": self.name,
            "version": self.version,
            "description": self.description,
            "framework": {"name": self.backend_name, "version": self.backend_constraint},
            "arch": self.arch,
            "reduced": self.reduced,
            "inputs": _io(self.inputs),
            "outputs": _io(self.outputs),
            "model": self.model_assets,
            "attributes": self.attributes,
        }

    def to_yaml(self) -> str:
        return _yaml().safe_dump(self.to_dict(), sort_keys=False)

    # -- validation --------------------------------------------------------
    def validate(self) -> None:
        if not self.name:
            raise ValueError("model manifest requires a name")
        parse_version(self.version)
        VersionConstraint(self.backend_constraint)  # raises on bad spec

    @property
    def key(self) -> str:
        """Registry key: name:version (artifact versioning, F5)."""
        return f"{self.name}:{self.version}"

    def checksum(self) -> str:
        """Content checksum of the manifest itself (reproducibility aid)."""
        return hashlib.sha256(self.to_yaml().encode()).hexdigest()[:16]


# --------------------------------------------------------------------------
# Backend ("framework") manifest (Listing 2)
# --------------------------------------------------------------------------
@dataclass
class BackendManifest:
    """The software stack: a compute backend + the mesh stacks it serves.

    The paper's ``containers: {amd64: {cpu: ..., gpu: ...}}`` becomes
    ``meshes: {host: ..., pod: ..., multipod: ...}`` — named device
    topologies the backend can provision.
    """

    name: str                                 # "ref" | "pallas"
    version: str = "1.0.0"
    description: str = ""
    meshes: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    attributes: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "BackendManifest":
        m = cls(
            name=d["name"],
            version=str(d.get("version", "1.0.0")),
            description=d.get("description", ""),
            meshes=dict(d.get("meshes", d.get("containers", {})) or {}),
            attributes=dict(d.get("attributes", {}) or {}),
        )
        parse_version(m.version)
        return m

    @classmethod
    def from_yaml(cls, text: str) -> "BackendManifest":
        return cls.from_dict(_yaml().safe_load(text))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "version": self.version,
            "description": self.description,
            "meshes": self.meshes,
            "attributes": self.attributes,
        }

    def to_yaml(self) -> str:
        return _yaml().safe_dump(self.to_dict(), sort_keys=False)

    @property
    def key(self) -> str:
        return f"{self.name}:{self.version}"


# --------------------------------------------------------------------------
# System requirements + scenario options (the other two user inputs, §4.1)
# --------------------------------------------------------------------------
@dataclass
class SystemRequirements:
    """Hardware constraints used for agent resolution (§4.7)."""

    platform: str = ""          # "cpu" | "tpu" | ""
    min_devices: int = 0
    min_memory_bytes: int = 0
    mesh: str = ""              # named mesh topology ("host", "pod", "multipod")

    def satisfied_by(self, info: Dict[str, Any]) -> bool:
        if self.platform and info.get("platform") != self.platform:
            return False
        if self.min_devices and int(info.get("num_devices", 0)) < self.min_devices:
            return False
        if self.min_memory_bytes and int(info.get("memory_bytes", 0)) < self.min_memory_bytes:
            return False
        if self.mesh and info.get("mesh") != self.mesh:
            return False
        return True


# --------------------------------------------------------------------------
# Engine knobs (serving-engine configuration, part of the evaluation spec)
# --------------------------------------------------------------------------
@dataclass
class EngineKnobs:
    """The serving-engine configuration an evaluation ran under.

    The paper's manifests make the model and software stack self-describing;
    the serving engine grew its own knobs (paged KV, speculative decoding,
    prefix caching, tensor parallelism, KV quantization) that change the
    measured numbers just as much — so they are recorded with every run and
    printed in the serve report header.
    """

    engine: str = "static"          # static | continuous | paged
    kv_dtype: str = "float32"       # KV pool storage dtype (int8/fp8 = quantized)
    page_size: int = 0              # tokens per KV page (0 = not paged)
    spec_k: int = 0                 # speculative draft depth (0 = off)
    prefix_cache: bool = False      # automatic prefix caching on?
    tp: int = 1                     # tensor-parallel degree
    recovery: str = "replay"        # fleet orphan recovery: replay | migrate
    checkpoint_every: int = 0       # decode steps between KV checkpoints

    def to_dict(self) -> Dict[str, Any]:
        return {
            "engine": self.engine,
            "kv_dtype": self.kv_dtype,
            "page_size": int(self.page_size),
            "spec_k": int(self.spec_k),
            "prefix_cache": bool(self.prefix_cache),
            "tp": int(self.tp),
            "recovery": self.recovery,
            "checkpoint_every": int(self.checkpoint_every),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EngineKnobs":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})

    def describe(self) -> str:
        """One-line report header, e.g.
        ``engine=paged kv_dtype=int8 page_size=16 spec_k=0 prefix_cache=on tp=1``.
        Recovery knobs print only when armed (old headers stay byte-stable)."""
        out = (
            f"engine={self.engine} kv_dtype={self.kv_dtype} "
            f"page_size={self.page_size} spec_k={self.spec_k} "
            f"prefix_cache={'on' if self.prefix_cache else 'off'} tp={self.tp}"
        )
        if self.recovery != "replay" or self.checkpoint_every:
            out += (f" recovery={self.recovery}"
                    f" checkpoint_every={self.checkpoint_every}")
        return out
