"""Three-term roofline from counted costs (the port's ``repro.roofline.model``).

    compute term    = FLOPs / (chips × peak_FLOP/s)
    memory term     = bytes / (chips × HBM_bw)
    collective term = collective_bytes / (chips × link_bw)

All terms in seconds for ONE step of the counted function.  The
reference reads its costs from a compiled artifact's HLO; the port counts
them while the function runs (:func:`~.count.count_costs`): the FLOPs and
bytes of every aten op it dispatches, each hand-written kernel's work
(:mod:`.work`) and each collective's bytes moved (the ledger of
:mod:`repro_torch.sharding.comm`, a real world's or a counting world's).
The counts are per device, as the reference's: per-device numbers × chips
= totals, and both give the same terms.  Dominant term = the bottleneck.

``link_bw`` is the H100 SXM data sheet's NVLink 4 rate, 900 GB/s a card.
A model axis of 16 spans two 8-card NVLink domains, whose link between
them is slower, so on the production meshes the collective term is a lower
bound.

``MODEL_FLOPS`` = 6·N·D for training (fwd+bwd), 2·N·D for inference, with
N = active params — the "useful work" yardstick; MODEL_FLOPS/counted FLOPs
exposes remat/redundancy waste.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict

from .count import Costs


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # per chip, bf16
    hbm_bw: float              # bytes/s per chip
    link_bw: float             # bytes/s per link
    hbm_bytes: float           # capacity per chip


# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, HBM3 rate and
# capacity; link_bw is NVLink 4's 900 GB/s a card (18 links, both ways)
H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=900e9,
    hbm_bytes=80e9,
)


@dataclass
class RooflineReport:
    """The reference's report, field for field, so one renderer reads both.

    In the port the counter (:func:`~.count.count_costs`) fills the
    per-device accounting, the collectives from its ledger, and the fields
    the reference takes from XLA's own analysis (``xla_flops``,
    ``xla_bytes``: the same counted FLOPs and bytes, since the port has no
    second analysis).  Where the counted call tracked its memory
    (:func:`~.count.count_call`) the argument, output and temp sizes are
    its ``memory_analysis()`` fields and ``peak_memory_bytes`` their peak
    (argument + output + temp - alias, as the reference reads XLA's);
    elsewhere those three are 0 and ``peak_memory_bytes`` is what the
    caller passes (``torch.cuda.max_memory_allocated`` over the run, 0 on
    the CPU)."""

    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device accounting from the counter
    flops_per_device: float
    memory_bytes_per_device: float
    collective_bytes_per_device: float
    by_collective: Dict[str, float]
    collective_count: Dict[str, int]
    # the reference's XLA-analysis fields: the counter's numbers again
    xla_flops: float
    xla_bytes: float
    # memory
    peak_memory_bytes: float
    argument_bytes: float
    output_bytes: float
    temp_bytes: float
    # terms (seconds)
    compute_term_s: float = 0.0
    memory_term_s: float = 0.0
    collective_term_s: float = 0.0
    dominant: str = ""
    # useful-work accounting
    model_flops: float = 0.0
    model_flops_ratio: float = 0.0
    step_time_bound_s: float = 0.0
    roofline_fraction: float = 0.0
    note: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RooflineReport":
        return cls(**d)


def model_flops_for(
    param_count_active: int, tokens: int, kind: str
) -> float:
    """6·N·D for training, 2·N·D for inference forward passes."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * param_count_active * tokens


def roofline_from_costs(
    costs: Costs,
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    hw: HardwareSpec = H100_SXM,
    model_flops: float = 0.0,
    peak_memory_bytes: float = 0.0,
    note: str = "",
) -> RooflineReport:
    """Build the report from one device's counted ``costs``."""
    mem = costs.memory
    if mem is not None:
        peak_memory_bytes = mem.peak_per_device_bytes
    compute_term = costs.flops / hw.peak_flops
    memory_term = costs.memory_bytes / hw.hbm_bw
    collective_term = costs.collective_bytes / hw.link_bw
    terms = {
        "compute": compute_term,
        "memory": memory_term,
        "collective": collective_term,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total_flops = costs.flops * chips
    ratio = model_flops / total_flops if total_flops else 0.0
    # roofline fraction: useful-model-FLOPs time at peak vs the bound time
    ideal_s = (model_flops / chips) / hw.peak_flops if chips else 0.0
    fraction = ideal_s / bound if bound > 0 else 0.0

    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        flops_per_device=costs.flops,
        memory_bytes_per_device=costs.memory_bytes,
        collective_bytes_per_device=costs.collective_bytes,
        by_collective=dict(costs.by_collective),
        collective_count=dict(costs.collective_count),
        xla_flops=costs.flops,
        xla_bytes=costs.memory_bytes,
        peak_memory_bytes=float(peak_memory_bytes),
        argument_bytes=float(mem.argument_bytes if mem else 0),
        output_bytes=float(mem.output_bytes if mem else 0),
        temp_bytes=float(mem.temp_bytes if mem else 0),
        compute_term_s=compute_term,
        memory_term_s=memory_term,
        collective_term_s=collective_term,
        dominant=dominant,
        model_flops=model_flops,
        model_flops_ratio=ratio,
        step_time_bound_s=bound,
        roofline_fraction=fraction,
        note=note,
    )
