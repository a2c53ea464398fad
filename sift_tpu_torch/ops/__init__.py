"""Per-stage ops; `*_cuda.py` hold the CUDA kernel wrappers (K1 and
K1-batch, K2 and K2-batch, K3, K4), each beside its plain PyTorch
version."""
