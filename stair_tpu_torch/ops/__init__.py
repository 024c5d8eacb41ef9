"""Kernels (CUDA C++ under ``csrc/``) and their plain PyTorch versions."""
