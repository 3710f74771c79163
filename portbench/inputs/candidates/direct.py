"""``{"kind": "direct"}``: order 0, the line of sight alone."""

import torch


def make(spec: dict, order: int, city: dict, rng):
    return torch.zeros((1, 0), dtype=torch.int64, device=city["device"])
