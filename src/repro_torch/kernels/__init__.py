# Hand-written Hopper kernels of the port, each beside its plain PyTorch
# version (ref.py) and its dispatching wrapper (ops.py):
#   population_lut  — the batched behavioural sim's population LUT gather
#                     (every QoR label goes through it)
#   approx_matmul   — rank-k deployment matmul and the bit-exact
#                     LUT matmul of one circuit choice
#   flash_attention — the LM's prefill attention (online softmax, GQA)
#   selective_scan  — the Mamba-1 prefill recurrence
from . import approx_matmul, flash_attention, population_lut, selective_scan

__all__ = ["approx_matmul", "flash_attention", "population_lut",
           "selective_scan"]
