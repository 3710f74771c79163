"""Differentiable coverage map with reflections and diffraction, on the PyTorch port
(the twin of ``coverage_map.py``).

Computes an order-2 coverage map over a street canyon, adds first-order
UTD edge diffraction, and runs gradient-descent steps that recover the
ground-truth permittivity from a target map. Runs on the GPU;
``main(device="cpu")`` runs it on the CPU.

Run: ``python examples/torch_coverage_map.py``
"""

import dataclasses

import torch

from differt_tpu_torch.coverage import power_map
from differt_tpu_torch.scenes import street_canyon_scene

FREQUENCY = 2.4e9


def main(device=None, grid: int = 32, steps: int = 30) -> dict:
    """Print the maps' ranges and the descent; return the losses and the recovered ``eta_r``."""
    device = torch.device("cuda" if device is None else device)
    scene = street_canyon_scene(device=device)
    scene = dataclasses.replace(
        scene, transmitters=torch.tensor([-30.0, 0.0, 20.0], device=device)
    ).with_receivers_grid(grid, grid, height=1.5)

    coverage = power_map(scene, FREQUENCY, order=2)
    db = 10 * torch.log10(torch.clamp(coverage, min=1e-30))
    print(f"order-2 coverage: {tuple(db.shape)}, {float(db.min()):.1f} dBW to {float(db.max()):.1f} dBW")

    with_diff = power_map(scene, FREQUENCY, order=1, with_diffraction=True)
    print(f"with diffraction: mean {float(with_diff.mean()):.3e} W")

    # Inverse problem: recover the permittivity by gradient descent.
    sigma = torch.tensor([0.1], device=device)
    true_eta = torch.tensor([5.24], device=device)
    target = power_map(scene, FREQUENCY, order=1, eta_r=true_eta, conductivity=sigma)

    def loss_fn(eta: torch.Tensor) -> torch.Tensor:
        pred = power_map(scene, FREQUENCY, order=1, eta_r=eta, conductivity=sigma)
        return torch.mean((torch.log10(pred + 1e-30) - torch.log10(target + 1e-30)) ** 2)

    eta = torch.tensor([2.0], device=device)
    losses = []
    for step in range(steps):
        eta = eta.detach().requires_grad_()
        loss = loss_fn(eta)
        (grad,) = torch.autograd.grad(loss, eta)
        eta, loss = eta.detach() - 20.0 * grad, loss.detach()
        losses.append(float(loss))
        if step % 10 == 0:
            print(f"step {step:2d}: loss {float(loss):.5f} eta {float(eta[0]):.3f}")
    print(f"recovered eta_r = {float(eta[0]):.3f} (true {float(true_eta[0]):.2f})")
    return {"coverage": coverage, "with_diffraction": with_diff, "losses": losses, "eta_r": float(eta[0])}


if __name__ == "__main__":
    main()
