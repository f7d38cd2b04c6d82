"""Request arrival processes (a copy of ``PoissonLoad`` and ``Request`` from
``repro.core.workload``; the port keeps its own copy so that it never
imports ``repro``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator

import numpy as np


@dataclass
class Request:
    """One inference request in a generated load."""

    request_id: int
    arrival_s: float       # offset from scenario start
    batch_size: int = 1
    tags: Dict[str, object] = field(default_factory=dict)


class PoissonLoad:
    """Online scenario: exponential inter-arrivals at ``rate_hz`` (batch 1)."""

    name = "poisson"

    def __init__(self, num_requests: int, rate_hz: float, seed: int = 0) -> None:
        if rate_hz <= 0:
            raise ValueError("rate_hz must be positive")
        self.num_requests = num_requests
        self.rate_hz = rate_hz
        self.seed = seed

    def requests(self) -> Iterator[Request]:
        rng = np.random.default_rng(self.seed)
        t = 0.0
        for i in range(self.num_requests):
            t += float(rng.exponential(1.0 / self.rate_hz))
            yield Request(request_id=i, arrival_s=t, batch_size=1)
