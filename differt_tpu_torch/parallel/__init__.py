"""Gradient steps on coverage maps, whole or streamed, on one device.

The device-mesh forms of the JAX package (``make_device_mesh``,
``shard_along``, ``replicate``, ``sharded_trace_paths``,
``sharded_power_map``) are not ported yet (ROADMAP A11).
"""

from ._sharding import (
    placement_training_step,
    streamed_placement_loss,
    streamed_placement_step,
    training_step,
)

__all__ = (
    "placement_training_step",
    "streamed_placement_loss",
    "streamed_placement_step",
    "training_step",
)
