"""Benchmark of the PyTorch/CUDA port adamvs_tpu_torch (see README.md)."""
