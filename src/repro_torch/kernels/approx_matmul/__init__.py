from .ops import (
    LUT_ROUTES,
    LUT_SHARED_MIN_WORK,
    ApproxSpec,
    PackedLut,
    approx_matmul,
    dequantize,
    from_circuit,
    grouped_matmul,
    grouped_rank_k_matmul_kernel,
    launch_lut,
    lut_matmul_kernel,
    lut_route,
    lut_swizzle,
    pack_groups,
    pack_lut,
    quantize_sym,
    rank_k_matmul_kernel,
)
from .ref import grouped_rank_k_matmul, lut_matmul, rank_k_matmul

__all__ = [
    "ApproxSpec", "from_circuit", "approx_matmul", "grouped_matmul",
    "quantize_sym", "dequantize",
    "lut_matmul", "rank_k_matmul", "lut_matmul_kernel", "rank_k_matmul_kernel",
    "pack_groups", "grouped_rank_k_matmul", "grouped_rank_k_matmul_kernel",
    "PackedLut", "pack_lut", "launch_lut", "lut_swizzle", "lut_route", "LUT_ROUTES",
    "LUT_SHARED_MIN_WORK",
]
