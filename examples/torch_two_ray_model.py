"""Two-ray ground-reflection model on the PyTorch port (the twin of ``two_ray_model.py``).

Traces the line of sight and one ground reflection over a sweep of
distances, computes the received power through the EM chain, and
differentiates it with respect to the receiver position and the ground's
permittivity. Runs on the GPU; ``main(device="cpu")`` runs it on the CPU.

Run: ``python examples/torch_two_ray_model.py``
"""

import torch

from differt_tpu_torch.coverage import complex_amplitudes, received_power
from differt_tpu_torch.em import z_0
from differt_tpu_torch.geometry import Mesh, Scene

FREQUENCY = 2.4e9
DISTANCES = (10.0, 30.0, 100.0, 300.0, 1000.0)


def main(device=None, distances=DISTANCES) -> dict:
    """Print the power at each distance and two gradients; return them."""
    device = torch.device("cuda" if device is None else device)
    tx = torch.tensor([0.0, 0.0, 10.0], device=device)
    eta_r = torch.tensor([5.24], device=device)  # Concrete.
    sigma = torch.tensor([0.0462 * 2.4**0.7822], device=device)
    ground = Mesh.plane(
        [0.0, 0.0, 0.0], normal=[0.0, 0.0, 1.0], side_length=2000.0, device=device
    ).set_materials("Concrete")

    def rx_at(x: torch.Tensor) -> torch.Tensor:
        return torch.stack((x, torch.zeros_like(x), torch.full_like(x, 1.5)))

    def power_at(rx: torch.Tensor, eta: torch.Tensor = eta_r) -> torch.Tensor:
        scene = Scene(transmitters=tx, receivers=rx, mesh=ground)
        a = torch.cat([
            complex_amplitudes(
                scene.trace_paths(order=order), scene, FREQUENCY, eta_r=eta, conductivity=sigma
            ).reshape(-1)
            for order in (0, 1)
        ])
        return torch.abs(a.sum()) ** 2 / z_0

    print("distance_m  power_dBW")
    powers = []
    for x in distances:
        p = power_at(rx_at(torch.tensor(x, device=device)))
        powers.append(float(p))
        print(f"{x:9.1f}  {10 * torch.log10(p):8.2f}")

    x = torch.tensor(100.0, device=device, requires_grad=True)
    (grad_rx,) = torch.autograd.grad(power_at(rx_at(x)), x)
    print(f"\nd(power)/d(rx_x) at 100 m: {float(grad_rx):.3e} W/m")

    eta = eta_r.clone().requires_grad_()
    scene = Scene(transmitters=tx, receivers=rx_at(torch.tensor(100.0, device=device)), mesh=ground)
    power = received_power(
        scene.trace_paths(order=1), scene, FREQUENCY, eta_r=eta, conductivity=sigma
    ).reshape(())
    (grad_eps,) = torch.autograd.grad(power, eta)
    print(f"d(power)/d(eta_r):         {float(grad_eps[0]):.3e} W")
    return {"powers": powers, "grad_rx": float(grad_rx), "grad_eta": float(grad_eps[0])}


if __name__ == "__main__":
    main()
