"""Distributed registry (paper F4/F5, §4.5.1).

A key-value store holding (a) registered model manifests and (b) running
agents with their HW/SW stack info. The paper uses an etcd-like distributed
KV store with dynamic registration; we implement the same semantics —
prefix scans, TTL leases with heartbeats, runtime add/delete — over an
in-process store that can optionally persist to a shared JSON file so that
subprocess agents on one host observe a single registry (the single-host
stand-in for the distributed deployment).

The port's copy of ``repro.core.registry``.  Every module of ``repro_torch``
keeps its own copy of what it needs so that it never imports ``repro``.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .manifest import BackendManifest, ModelManifest, SystemRequirements, VersionConstraint


@dataclass
class Entry:
    value: Dict[str, Any]
    expires_at: Optional[float] = None  # None = no lease (static entry)


class KVStore:
    """TTL'd key-value store with prefix scan (the etcd stand-in)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic) -> None:
        self._lock = threading.Lock()
        self._data: Dict[str, Entry] = {}
        self._clock = clock

    def put(self, key: str, value: Dict[str, Any], ttl: Optional[float] = None) -> None:
        expires = self._clock() + ttl if ttl is not None else None
        with self._lock:
            self._data[key] = Entry(value=value, expires_at=expires)

    def update_value(self, key: str, value: Dict[str, Any]) -> bool:
        """Replace a live entry's value, preserving its lease."""
        with self._lock:
            e = self._data.get(key)
            if e is None or self._expired(e):
                self._data.pop(key, None)
                return False
            e.value = value
            return True

    def mutate(self, key: str, fn: Callable[[Dict[str, Any]], Dict[str, Any]]
               ) -> bool:
        """Atomic read-modify-write on a live entry: ``fn`` receives a copy
        of the current value and returns the replacement, all under the
        store lock — the race-free path for counters like agent load (a
        get/modify/update_value sequence can lose concurrent updates)."""
        with self._lock:
            e = self._data.get(key)
            if e is None or self._expired(e):
                self._data.pop(key, None)
                return False
            e.value = fn(dict(e.value))
            return True

    def renew(self, key: str, ttl: float) -> bool:
        """Heartbeat: extend a lease. Returns False if the key expired."""
        with self._lock:
            e = self._data.get(key)
            if e is None or self._expired(e):
                self._data.pop(key, None)
                return False
            e.expires_at = self._clock() + ttl
            return True

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            e = self._data.get(key)
            if e is None:
                return None
            if self._expired(e):
                del self._data[key]
                return None
            # a copy: callers must not mutate store state outside the lock
            # (use mutate() for read-modify-write)
            return dict(e.value)

    def delete(self, key: str) -> bool:
        with self._lock:
            return self._data.pop(key, None) is not None

    def scan(self, prefix: str) -> List[Tuple[str, Dict[str, Any]]]:
        with self._lock:
            # expiry cutoff taken INSIDE the lock: a renew that wins the
            # lock first extends the lease and the scan sees it live; one
            # that loses sees the entry purged and returns False — no
            # window where an expired agent is both renewable and listed
            now = self._clock()
            dead = [k for k, e in self._data.items() if self._expired(e, now)]
            for k in dead:
                del self._data[k]
            return sorted(
                (k, dict(e.value))
                for k, e in self._data.items() if k.startswith(prefix)
            )

    def _expired(self, e: Entry, now: Optional[float] = None) -> bool:
        if e.expires_at is None:
            return False
        return (now if now is not None else self._clock()) > e.expires_at

    # -- optional shared-file persistence (single-host "distributed") ------
    def dump(self, path: str) -> None:
        with self._lock:
            # serialize INSIDE the lock: values are live dicts, and a
            # concurrent mutate() mid-json.dump would tear the snapshot
            # (the file write itself stays outside — atomic via rename)
            payload_text = json.dumps({
                k: {"value": e.value, "expires_at": e.expires_at}
                for k, e in self._data.items()
            })
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        with os.fdopen(fd, "w") as f:
            f.write(payload_text)
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        with open(path) as f:
            payload = json.load(f)
        with self._lock:
            for k, d in payload.items():
                self._data[k] = Entry(value=d["value"], expires_at=d.get("expires_at"))


@dataclass
class AgentRecord:
    """A registered agent: its HW/SW stack + models it can serve (§4.4 init)."""

    agent_id: str
    backend: str                 # backend name, e.g. "ref" | "pallas"
    backend_version: str
    system: Dict[str, Any]       # platform, num_devices, memory_bytes, mesh, host
    models: List[str] = field(default_factory=list)  # model manifest keys
    address: str = ""            # in-proc handle name or host:port
    load: int = 0                # outstanding evaluations (for balancing)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "agent_id": self.agent_id,
            "backend": self.backend,
            "backend_version": self.backend_version,
            "system": self.system,
            "models": self.models,
            "address": self.address,
            "load": self.load,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AgentRecord":
        return cls(**d)


class Registry:
    """The MLModelScope distributed registry facade.

    Namespaces::

        manifests/<name>:<version>   -> model manifest dict
        backends/<name>:<version>    -> backend manifest dict
        agents/<agent_id>            -> AgentRecord dict   (TTL lease)
    """

    AGENT_TTL = 10.0  # seconds; agents heartbeat at TTL/3

    def __init__(self, store: Optional[KVStore] = None) -> None:
        self.store = store or KVStore()

    # -- manifests ---------------------------------------------------------
    def register_manifest(self, manifest: ModelManifest) -> str:
        self.store.put(f"manifests/{manifest.key}", manifest.to_dict())
        return manifest.key

    def register_backend(self, manifest: BackendManifest) -> str:
        self.store.put(f"backends/{manifest.key}", manifest.to_dict())
        return manifest.key

    def unregister_manifest(self, key: str) -> bool:
        return self.store.delete(f"manifests/{key}")

    def manifests(self, name: str = "") -> List[ModelManifest]:
        return [
            ModelManifest.from_dict(v)
            for _, v in self.store.scan(f"manifests/{name}")
        ]

    def find_manifest(
        self, name: str, constraint: str = ""
    ) -> Optional[ModelManifest]:
        """Highest version satisfying the constraint (F5 resolution)."""
        cons = VersionConstraint(constraint)
        best: Optional[ModelManifest] = None
        for m in self.manifests(name):
            if m.name != name or not cons.satisfied_by(m.version):
                continue
            if best is None or _ver(m.version) > _ver(best.version):
                best = m
        return best

    # -- agents --------------------------------------------------------------
    def register_agent(self, record: AgentRecord, ttl: Optional[float] = None) -> None:
        self.store.put(
            f"agents/{record.agent_id}", record.to_dict(), ttl=ttl or self.AGENT_TTL
        )

    def heartbeat(self, agent_id: str, ttl: Optional[float] = None) -> bool:
        return self.store.renew(f"agents/{agent_id}", ttl if ttl is not None else self.AGENT_TTL)

    def deregister_agent(self, agent_id: str) -> bool:
        return self.store.delete(f"agents/{agent_id}")

    def agents(self) -> List[AgentRecord]:
        return [AgentRecord.from_dict(v) for _, v in self.store.scan("agents/")]

    def update_load(self, agent_id: str, delta: int) -> None:
        def bump(rec: Dict[str, Any]) -> Dict[str, Any]:
            rec["load"] = max(0, int(rec.get("load", 0)) + delta)
            return rec

        # atomic RMW under the store lock: two concurrent dispatches must
        # not lose a load increment (get -> modify -> update_value races)
        self.store.mutate(f"agents/{agent_id}", bump)

    # -- resolution (server-side, §4.3 step 3) -------------------------------
    def resolve(
        self,
        model_key: str,
        backend_name: str = "",
        backend_constraint: str = "",
        requirements: Optional[SystemRequirements] = None,
    ) -> List[AgentRecord]:
        """Agents able to run ``model_key`` under the given constraints,
        least-loaded first (the registry load-balances requests, §4.5.1)."""
        cons = VersionConstraint(backend_constraint)
        reqs = requirements or SystemRequirements()
        out = []
        for rec in self.agents():
            if model_key not in rec.models:
                continue
            if backend_name and rec.backend != backend_name:
                continue
            if backend_constraint and not cons.satisfied_by(rec.backend_version):
                continue
            if not reqs.satisfied_by(rec.system):
                continue
            out.append(rec)
        out.sort(key=lambda r: (r.load, r.agent_id))
        return out


def _ver(v: str) -> Tuple[int, ...]:
    from .manifest import parse_version

    return parse_version(v)
