"""All propagation mechanisms on one NLoS link, on the PyTorch port
(the twin of ``propagation_mechanisms.py``).

A box obstacle on a ground plane blocks the direct TX-RX path; this
example runs every mechanism the port models and compares their
contributions to the received power:

- pure specular reflections (image method),
- first-order edge diffraction (closed-form Keller points + UTD),
- mixed chains (reflect off the ground, then diffract over the roof:
  Fermat solver),
- double diffraction over the roof (two edges),
- diffuse scattering (Degli-Esposti effective roughness),
- and a directive TX antenna pattern on top.

Runs on the GPU; ``main(device="cpu")`` runs it on the CPU.

Run: ``python examples/torch_propagation_mechanisms.py``
"""

import torch

from differt_tpu_torch.coverage import complex_amplitudes, received_power
from differt_tpu_torch.em import HWDipolePattern, InteractionType, z_0
from differt_tpu_torch.geometry import Mesh, Scene
from differt_tpu_torch.rt import (
    MixedPathTracer,
    diffraction_amplitudes,
    mixed_amplitudes,
    scattering_amplitudes,
)

FREQUENCY = 2.4e9
R = InteractionType.REFLECTION
D = InteractionType.DIFFRACTION


def power_of(amplitudes: torch.Tensor, mask: torch.Tensor) -> float:
    a = torch.where(mask, amplitudes, 0.0)
    return float(torch.abs(a.sum()) ** 2 / z_0)


def main(device=None) -> dict:
    """Print each mechanism's paths and power; return the powers (W) by mechanism."""
    device = torch.device("cuda" if device is None else device)
    eta_r = torch.tensor([5.24], device=device)
    sigma = torch.tensor([0.1], device=device)
    ground = Mesh.plane([0.0, 0.0, 0.0], normal=[0.0, 0.0, 1.0], side_length=40.0, device=device)
    box = Mesh.box(2.0, 6.0, 3.0, with_top=True, device=device).translate([0.0, 0.0, 1.5])
    mesh = (ground + box).dedup_vertices().set_materials("Concrete")
    # A deep-shadow receiver: LoS, ground bounce, and even single
    # diffraction are all blocked; only double diffraction over the roof
    # and diffuse scattering reach it. (Raise it to z = 5 and single
    # diffraction + reflect->diffract take over instead.)
    tx = torch.tensor([[-8.0, 0.0, 1.6]], device=device)
    scene = Scene(transmitters=tx, receivers=torch.tensor([[8.0, 0.0, 1.4]], device=device), mesh=mesh)
    high = Scene(transmitters=tx, receivers=torch.tensor([[8.0, 0.0, 5.0]], device=device), mesh=mesh)
    edges, adjacent, wedge_n = scene.mesh._diffraction_edges_info()
    common = {
        "edges": edges, "adjacent_triangles": adjacent, "wedge_n": wedge_n,
        "eta_r": eta_r, "conductivity": sigma,
    }
    powers = {}

    print("deep-shadow receiver (z = 1.4):")
    los = scene.trace_paths(order=0)
    print(f"  LoS blocked: {int(los.mask.sum()) == 0}")

    tracer = MixedPathTracer()
    dd = tracer.trace_paths(scene, [D, D])
    a_dd = mixed_amplitudes(dd, scene, FREQUENCY, **common)
    powers["double_diffraction"] = power_of(a_dd, dd.mask)
    print(f"  double diffraction: {int(dd.mask.sum()):3d} paths, {powers['double_diffraction']:.3e} W")
    v = dd.vertices[dd.mask]
    top = v[((v[:, 1, 2] - 3).abs() < 1e-3) & ((v[:, 2, 2] - 3).abs() < 1e-3)]
    print(f"  over-the-roof path: {[[round(c, 3) for c in p] for p in top[0].tolist()]}")

    scat = scene.trace_scattering_paths(num_samples=4)
    a_scat = scattering_amplitudes(
        scat, scene, FREQUENCY, eta_r=eta_r, conductivity=sigma,
        scattering_coefficient=0.3, num_samples=4,
    )
    powers["scattering"] = float(torch.sum(torch.abs(a_scat) ** 2) / z_0)  # incoherent sum
    print(f"  diffuse scattering: {int(scat.mask.sum()):3d} paths, {powers['scattering']:.3e} W")

    print("elevated receiver (z = 5):")
    diff = high.trace_diffraction_paths()
    a_diff = diffraction_amplitudes(diff, high, FREQUENCY, **common)
    powers["diffraction"] = power_of(a_diff, diff.mask)
    print(f"  single diffraction: {int(diff.mask.sum()):3d} paths, {powers['diffraction']:.3e} W")

    rd = tracer.trace_paths(high, [R, D])
    a_rd = mixed_amplitudes(rd, high, FREQUENCY, **common)
    powers["reflect_diffract"] = power_of(a_rd, rd.mask)
    print(f"  reflect->diffract : {int(rd.mask.sum()):3d} paths, {powers['reflect_diffract']:.3e} W")

    spec = high.trace_paths(order=1)
    a_spec = complex_amplitudes(spec, high, FREQUENCY, eta_r=eta_r, conductivity=sigma)
    powers["reflection"] = power_of(a_spec, spec.mask)
    print(f"  order-1 reflection: {int(spec.mask.sum()):3d} paths, {powers['reflection']:.3e} W")

    # A directive TX on the scattered paths of the deep-shadow link.
    pattern = HWDipolePattern(
        frequency=FREQUENCY,
        center=torch.zeros(3, device=device),
        direction=torch.tensor([0.0, 0.0, 1.0], device=device),
    )
    p_iso = received_power(scat, scene, FREQUENCY, eta_r=eta_r, conductivity=sigma, coherent=False)
    p_dip = received_power(
        scat, scene, FREQUENCY, eta_r=eta_r, conductivity=sigma, coherent=False, tx_pattern=pattern
    )
    powers["dipole_gain"] = float((p_dip / p_iso)[0, 0])
    print(f"half-wave dipole TX: scattered power x{powers['dipole_gain']:.3f} vs isotropic")
    return powers


if __name__ == "__main__":
    main()
