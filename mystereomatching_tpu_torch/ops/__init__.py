"""Stereo ops on torch tensors.

Layouts are the JAX package's: cost volumes ``[D, H, W]``, cross arms
``[4, H, W]`` in left, right, up, down order, images ``[H, W]`` gray or
``[H, W, 3]`` colour, float32 in [0, 255]. A function backed by a CUDA
kernel (``ops/cuda_kernels.py``) launches it for a CUDA tensor and runs
its plain torch version, kept beside it, for a CPU tensor.
"""
