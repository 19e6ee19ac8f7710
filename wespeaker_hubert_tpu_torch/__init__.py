"""wespeaker_hubert_tpu_torch: the PyTorch / CUDA port of wespeaker_hubert_tpu.

The JAX package `wespeaker_hubert_tpu` is the reference; this package keeps
its module paths and names so each counterpart is easy to find.  It imports
torch, numpy and the standard library only.  Entry points run on CUDA by
default and raise without a GPU; pass device="cpu" to run the plain PyTorch
versions on the CPU.  Hand-written CUDA kernels live in `csrc/` and are
built with nvcc at first use (utils/cuda_build.py).
"""
