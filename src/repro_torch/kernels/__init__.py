"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``), the nvcc/ctypes builder (``build``) and the device dispatch
(``ops``).

flash_attention         prefill attention (csrc/flash_attention.cu)
decode_attention        one-token decode over a contiguous KV cache
paged_decode_attention  the same through a page table (csrc/decode_attention.cu)
moe_gmm                 grouped expert GEMM of the MoE layers (csrc/moe_gmm.cu)
ssd_scan                Mamba2 chunked SSD prefill scan (csrc/ssd_scan.cu)

Importing this package builds nothing: a kernel is compiled at its first
launch on a CUDA tensor.
"""
