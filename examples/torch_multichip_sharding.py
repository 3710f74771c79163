"""Sharded coverage map and training steps on a device mesh, on the PyTorch port
(the twin of ``multichip_sharding.py``).

The mesh is a ``torch.distributed`` process group. Run as it is, the script
makes a group of one rank (NCCL on the GPU, gloo with ``device="cpu"``); under
``torchrun --nproc-per-node N`` each rank joins the group that torchrun set
up, takes its block of the receivers, and every rank gets the whole map.

Run: ``python examples/torch_multichip_sharding.py``
"""

import dataclasses

import torch
import torch.distributed as dist

from differt_tpu_torch.parallel import make_device_mesh, sharded_power_map, training_step
from differt_tpu_torch.scenes import street_canyon_scene

FREQUENCY = 2.4e9


def main(device=None, grid: int = 32, steps: int = 5) -> dict:
    """Print the mesh, the sharded map and the steps; return the map and the losses."""
    if device is None and dist.is_initialized() and torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    made_group = not dist.is_initialized()
    mesh = make_device_mesh(device=device)
    device = mesh.device
    print(f"ranks: {mesh.size} x {device.type} ({dist.get_backend(mesh.group)})")

    scene = street_canyon_scene(device=device)
    scene = dataclasses.replace(
        scene, transmitters=torch.tensor([-30.0, 0.0, 20.0], device=device)
    ).with_receivers_grid(grid, grid, height=1.5)

    coverage = sharded_power_map(scene, FREQUENCY, mesh, order=2)
    print(f"sharded coverage map: {tuple(coverage.shape)}, mean {float(coverage.mean()):.3e} W")

    sigma = torch.tensor([0.1], device=device)
    target = 10.0 * torch.log10(
        torch.clamp(sharded_power_map(scene, FREQUENCY, mesh, order=1), min=1e-30)
    )
    eta = torch.tensor([2.0], device=device)
    losses = []
    for step in range(steps):
        eta, loss = training_step(
            scene, FREQUENCY, mesh, order=1,
            eta_r=eta, conductivity=sigma, target_power=target, learning_rate=1e-2,
        )
        losses.append(float(loss))
        print(f"step {step}: loss {float(loss):.4f} eta {float(eta[0]):.3f}")
    if made_group:
        dist.destroy_process_group()
    return {"coverage": coverage, "losses": losses, "eta_r": float(eta[0])}


if __name__ == "__main__":
    main()
