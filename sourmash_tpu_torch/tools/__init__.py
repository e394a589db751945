"""The sketch-kernel instruments, on the card: counterparts of the JAX
package's Pallas experiments under `tools/` that take K1 (the fused
sketch kernel) apart to find where its time goes.

    python -m sourmash_tpu_torch.tools.exp_split_kernel [check|time]
    python -m sourmash_tpu_torch.tools.exp_v2_kernel [check|time]
    python -m sourmash_tpu_torch.tools.profile_sketch_parts [murmur] [assembly] [mulN ...]
    python -m sourmash_tpu_torch.tools.profile_sketch_chain [full] [kernel] [gatheronly]

Modes, printed lines and shapes are the JAX tools': B = 8 rows of
2^21 + 30 bytes (2^21 windows each), k = 31, seed 42, 4 slots, max_hash
2^64 / 1000; a timing is 24 back-to-back batches, best of 2, by CUDA
events. The kernels are hand-written CUDA (`csrc/sketch_parts.cu`,
`ops/cuda_sketch_parts.py`) beside K1 (`csrc/sketch.cu`). Each tool runs
on CUDA unless SOURMASH_TORCH_DEVICE=cpu asks for the CPU, where the
kernels' plain PyTorch versions run; without a card it raises.
"""
