"""``{"kind": "streets", "nx": nx, "ny": ny, "spacing_m": s, "height_m": z}``: ``nx x ny``
points on the street centrelines at multiples of ``s`` around the origin
(frozen from ``chip_smoke.py::street_receivers``, commit ``d3b5058``)."""

import torch


def make(spec: dict, center, device) -> torch.Tensor:
    nx, ny, step = spec["nx"], spec["ny"], spec["spacing_m"]
    y, x = torch.meshgrid(
        step * torch.arange(-ny // 2, ny // 2, device=device, dtype=torch.float32),
        step * torch.arange(-nx // 2, nx // 2, device=device, dtype=torch.float32),
        indexing="ij",
    )
    return torch.stack((x, y, torch.full_like(x, spec["height_m"])), dim=-1).reshape(-1, 3).contiguous()
