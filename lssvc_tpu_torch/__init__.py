"""PyTorch / CUDA port of the LSSVC two-layer video codec.

NHWC activations at every public function; parameters keyed by the
reference's torch state_dict names, in torch layouts (see convert.py).
The warps and the fused conv chain run as hand-written CUDA kernels on the
GPU (ops/warp_kernels.py with csrc/warp.cu, ops/conv_chain.py with
csrc/conv_chain.cu) and as their plain PyTorch versions on the CPU.
"""
