"""The port's roofline: FLOPs, bytes, collectives and memory counted while
a function runs (:mod:`.count`), each hand-written kernel's work from its
shapes (:mod:`.work`) and the three-term roofline on an H100
(:mod:`.model`)."""
from . import work
from .count import Costs, MemoryAnalysis, count_call, count_costs, counting
from .model import H100_SXM, HardwareSpec, RooflineReport, model_flops_for, roofline_from_costs

__all__ = [
    "Costs",
    "H100_SXM",
    "HardwareSpec",
    "MemoryAnalysis",
    "RooflineReport",
    "count_call",
    "count_costs",
    "counting",
    "model_flops_for",
    "roofline_from_costs",
    "work",
]
