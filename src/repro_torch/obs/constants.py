"""The roofline constants the planner's modeled times divide by
(counterpart of `repro.obs.constants`).

Every modeled time in the port (`repro_torch.graph.registry.unit_model_us`,
which the planner's arms compare) divides FLOPs and HBM bytes by
`DEFAULT_ROOFLINE` wherever no calibration covers the key. Its defaults are
the NVIDIA H100 SXM's datasheet figures: 67 TFLOP/s of fp32 outside the
tensor cores and 3.35 TB/s of HBM3. They are peaks, not what the kernels
achieve: `repro_torch.obs.calibrate.CalibrationDB` fits effective
constants per impl from measured kernel times. The reference's defaults
describe another device and are not carried over; tests that compare plans
of the two packages patch this module's `DEFAULT_ROOFLINE` with the
reference's values (every reader looks it up at call time).

The dry run (`repro_torch.launch.dryrun`) prices a rank's counted work
with the H100 SXM's datasheet figures below: the bf16 dense tensor-core
peak, HBM3, and two link classes for the collectives. A group whose ranks
all lie in one 8-rank node (consecutive ranks, torchrun's placement) moves
its bytes over NVLink 4; any other group over the node's network, one NDR
400 Gb/s port a GPU. The reference's v5e constants and its `3 x LINK_BW`
ICI figure are not carried over.

Stays dependency-free (stdlib only): it sits below the op registry.
"""
from __future__ import annotations

from dataclasses import dataclass

DEFAULT_PEAK_FLOPS = 67e12  # FLOP/s: H100 SXM fp32, CUDA cores
DEFAULT_HBM_BW = 3.35e12  # B/s: H100 SXM HBM3

BF16_PEAK_FLOPS = 989e12  # FLOP/s: H100 SXM bf16 dense, tensor cores
NVLINK_BW = 450e9  # B/s: NVLink 4, per direction per GPU
NETWORK_BW = 50e9  # B/s: one NDR 400 Gb/s port per GPU, between nodes
RANKS_PER_NODE = 8  # GPUs a node: consecutive ranks share one


def link_of(ranks) -> str:
    """The link a group's collectives cross: "nvlink" when all its ranks
    lie in one node, "network" otherwise."""
    return "nvlink" if len({int(r) // RANKS_PER_NODE for r in ranks}) == 1 else "network"


LINK_BW = {"nvlink": NVLINK_BW, "network": NETWORK_BW}


@dataclass(frozen=True)
class RooflineConstants:
    """One (compute ceiling, memory ceiling) pair."""

    peak_flops: float = DEFAULT_PEAK_FLOPS
    hbm_bw: float = DEFAULT_HBM_BW

    def time_us(self, flops: float, nbytes: float) -> float:
        """Roofline time (us): max of the compute and memory terms."""
        return max(flops / self.peak_flops, nbytes / self.hbm_bw) * 1e6


DEFAULT_ROOFLINE = RooflineConstants()
