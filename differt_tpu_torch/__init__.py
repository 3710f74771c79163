"""differt_tpu_torch: the PyTorch + CUDA port of differt_tpu, for NVIDIA Hopper.

It covers four paths. Coverage: the coverage map of any order, with hard
or sigmoid-smoothed validity masks, isotropic or through an
antenna pattern (meshes and scenes, candidate decoding, image-method
tracing with its checks, the slab-Fresnel Jones chain and chunked power
maps). Hybrid tracing: visibility estimated by ray launching prunes the
candidates before the exact trace (``Scene.trace_paths(solver="hybrid")``,
with the candidate DFS of ``native`` built by ``g++`` at first use). Ray
launching: SBR (``Scene.launch_paths``), the multipath lifetime map
(``Scene.compute_tx_mlm``) and the differentiable closest hit. Gradients on
one device: the maps are differentiable with respect to transmitters,
materials and vertices, and ``parallel`` holds the gradient steps, whole or
streamed over a city-scale grid. Three hand-written CUDA kernels carry them
on the card (``csrc/anyhit.cu``, ``csrc/trace.cu``, ``csrc/closest.cu``),
walking a BVH that each mesh builds once (``Mesh.bvh``); each has a plain
PyTorch version, which CPU tensors use (``ops.set_backend`` picks
otherwise). The entry points that make tensors (scenes, ``Mesh``
constructors, candidates, the lattice, antennas, ``interop``) build on the
card unless given ``device="cpu"``. Scenes load from disk (``io``: OBJ,
with the native parser, PLY and Sionna XML; ``Scene.load_xml``) and
traced paths export to DeepMIMO's per-path channels
(``plugins.deepmimo.export``); ``treekit`` writes checkpoints that the
JAX package reads, and reads its. The package never imports JAX.
"""

from . import coverage, em, geometry, interop, io, native, ops, parallel, plugins, profiling, rt, scenes, treekit, utils

__all__ = (
    "coverage",
    "em",
    "geometry",
    "interop",
    "io",
    "native",
    "ops",
    "parallel",
    "plugins",
    "profiling",
    "rt",
    "scenes",
    "treekit",
    "utils",
)
