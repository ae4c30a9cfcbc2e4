from .ops import (
    ApproxSpec,
    approx_matmul,
    dequantize,
    from_circuit,
    grouped_matmul,
    lut_matmul_kernel,
    quantize_sym,
    rank_k_matmul_kernel,
)
from .ref import lut_matmul, rank_k_matmul

__all__ = [
    "ApproxSpec", "from_circuit", "approx_matmul", "grouped_matmul",
    "quantize_sym", "dequantize",
    "lut_matmul", "rank_k_matmul", "lut_matmul_kernel", "rank_k_matmul_kernel",
]
