"""Per-shard kernels: torch.sort wrappers and the block-bitonic CUDA kernels."""
