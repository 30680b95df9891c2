"""Layers and the three hand-written kernels of the port (w8a16 matmul,
fused residual + LayerNorm, flash attention), each with its plain PyTorch
version for CPU tensors."""
