"""Device meshes and gradient steps on coverage maps, over ``torch.distributed``.

The scene is replicated on every rank of a 1-D :class:`DeviceMesh` (the
first ranks of the default process group, NCCL on GPUs, gloo on the CPU);
the embarrassingly parallel axes, receivers or path candidates, are split
into one block a rank. Each rank traces its block with the same kernels as
on one device, and the blocks are gathered, so every rank holds the whole
result. The forward needs no other communication. Gradients of replicated
inputs are summed over the ranks: the backward of :func:`replicate`'s
broadcast is an ``all_reduce``, the backward of the gather a slice, and the
streamed step sums its gradients once a step. With ``mesh=None`` every
function runs on one device with no collective.
"""

from ._sharding import (
    DeviceMesh,
    make_device_mesh,
    placement_training_step,
    replicate,
    shard_along,
    sharded_power_map,
    sharded_trace_paths,
    streamed_placement_loss,
    streamed_placement_step,
    training_step,
)

__all__ = (
    "DeviceMesh",
    "make_device_mesh",
    "placement_training_step",
    "replicate",
    "shard_along",
    "sharded_power_map",
    "sharded_trace_paths",
    "streamed_placement_loss",
    "streamed_placement_step",
    "training_step",
)
