"""Per-stage ops; `*_cuda.py` hold the four CUDA kernel wrappers, each
beside its plain PyTorch version."""
