"""Peaks of one NVIDIA H100 SXM (NVIDIA data sheet, dense rates) and the
least time a kernel's work can take on it.

Frozen copies of `chip_smoke.bound` and `chip_smoke.bound_tc`, in
seconds."""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    """max(bytes / HBM bandwidth, operations / the dtype's peak)."""
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[dtype])


def bound_tc_s(nbytes: float, tc_flops: float, f32_flops: float = 0.0) -> float:
    """bound_s for a kernel whose products run on the tensor cores (bf16
    operands, float32 sums) beside float32 work on the CUDA cores: the
    largest of the three times."""
    return max(nbytes / HBM_BYTES_S, tc_flops / PEAK_FLOPS["bfloat16"],
               f32_flops / PEAK_FLOPS["float32"])
