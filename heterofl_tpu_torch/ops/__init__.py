"""Ops: masked layers, augmentation, and the CUDA-kernel ops (fused batch
norm, fused masked-SGD) with their plain PyTorch versions."""
