"""Hand-written Hopper kernels, each beside its plain PyTorch version.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise. There is no fallback from one to the other.
"""
