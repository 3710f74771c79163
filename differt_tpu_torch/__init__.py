"""differt_tpu_torch: the PyTorch + CUDA port of differt_tpu, for NVIDIA Hopper.

This slice covers the forward coverage map of orders 0, 1 and 2 with hard
validity masks: meshes and scenes, candidate decoding, image-method tracing
with its checks, the slab-Fresnel Jones chain and chunked power maps. Two
hand-written CUDA kernels carry it on the card (``csrc/anyhit.cu`` and
``csrc/trace.cu``); each has a plain PyTorch version, which CPU tensors
use. The package never imports JAX.
"""

from . import coverage, em, geometry, interop, ops, rt, scenes, utils

__all__ = ("coverage", "em", "geometry", "interop", "ops", "rt", "scenes", "utils")
