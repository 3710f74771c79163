"""``{"kind": "square", "n": n, "half_m": h, "height_m": z}``: an ``n x n`` grid on
``+-h`` around the center's x and y, row by row in y."""

import torch


def make(spec: dict, center, device) -> torch.Tensor:
    xs = torch.linspace(-spec["half_m"], spec["half_m"], spec["n"], device=device)
    y, x = torch.meshgrid(xs + center[1], xs + center[0], indexing="ij")
    return torch.stack((x, y, torch.full_like(x, spec["height_m"])), dim=-1).reshape(-1, 3).contiguous()
