"""The roofline constants the planner's modeled times divide by
(counterpart of `repro.obs.constants`).

Every modeled time in the port (`repro_torch.graph.registry.unit_model_us`,
which the planner's BSR and int8 arms compare) divides FLOPs and HBM bytes
by `DEFAULT_ROOFLINE`. Its defaults are the NVIDIA H100 SXM's datasheet
figures: 67 TFLOP/s of fp32 on CUDA cores, the precision the port's fp32
kernels run in (no TF32, no tensor cores), and 3.35 TB/s of HBM3. They are
peaks, not what the kernels achieve; fitting effective constants from
measured kernel times (the reference's `CalibrationDB`) is a later slice.
The reference's defaults describe another device and are not carried over;
tests that compare plans of the two packages patch this module's
`DEFAULT_ROOFLINE` with the reference's values, read at test time.

Stays dependency-free (stdlib only): it sits below the op registry.
"""
from __future__ import annotations

from dataclasses import dataclass

DEFAULT_PEAK_FLOPS = 67e12  # FLOP/s: H100 SXM fp32, CUDA cores
DEFAULT_HBM_BW = 3.35e12  # B/s: H100 SXM HBM3


@dataclass(frozen=True)
class RooflineConstants:
    """One (compute ceiling, memory ceiling) pair."""

    peak_flops: float = DEFAULT_PEAK_FLOPS
    hbm_bw: float = DEFAULT_HBM_BW

    def time_us(self, flops: float, nbytes: float) -> float:
        """Roofline time (us): max of the compute and memory terms."""
        return max(flops / self.peak_flops, nbytes / self.hbm_bw) * 1e6


DEFAULT_ROOFLINE = RooflineConstants()
