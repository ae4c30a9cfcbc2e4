"""Population LUT gather: the batched behavioural sim's inner gather as
a CUDA kernel for Hopper (``csrc/population_lut.cu``) beside its plain
PyTorch version.

``out[g, m, s] = lut[genes[g, s], s, cols[m, s]]`` — one gathered
product per (genome, input element, multiplier slot).
"""

from .ops import population_lut_gather
from .ref import population_lut_gather_ref

__all__ = ["population_lut_gather", "population_lut_gather_ref"]
