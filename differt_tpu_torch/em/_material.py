"""ITU-R P.2040-4 materials (PyTorch port of ``differt_tpu.em._material``).

Relative permittivity is ``a * f_GHz**b`` and conductivity ``c * f_GHz**d``
in each frequency range; outside every range both are -1. The first range
(sorted by lower bound) that contains the frequency wins.
"""

import dataclasses
import math

import torch

# (a, b, c, d, (f_min_GHz, f_max_GHz) | None)
ItuRow = tuple[float, float, float, float, "tuple[float, float] | None"]


@dataclasses.dataclass(frozen=True)
class Material:
    """A material with frequency-dependent electrical properties.

    >>> import torch
    >>> round(float(materials["Concrete"].relative_permittivity(torch.tensor(3e9))), 2)
    5.24
    """

    name: str
    rows: tuple[ItuRow, ...]
    thickness: float | None = None

    def properties(self, frequency: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(relative_permittivity, conductivity)`` at ``frequency`` (Hz)."""
        f_hz = torch.as_tensor(frequency, dtype=torch.float32)
        f_ghz = f_hz * 1e-9
        rel_perm = torch.full_like(f_ghz, -1.0)
        cond = torch.full_like(f_ghz, -1.0)
        ranges = [
            (r[4][0] * 1e9, r[4][1] * 1e9) if r[4] is not None else (-math.inf, math.inf)
            for r in self.rows
        ]
        order = sorted(range(len(self.rows)), key=lambda i: ranges[i])
        # Reverse order, so that the first (lowest) matching range wins.
        for i in reversed(order):
            a, b, c, d, _ = self.rows[i]
            lo, hi = ranges[i]
            in_range = (f_hz >= lo) & (f_hz <= hi)
            rel_perm = torch.where(in_range, a * f_ghz**b, rel_perm)
            cond = torch.where(in_range, c * f_ghz**d, cond)
        return rel_perm, cond

    def relative_permittivity(self, frequency: torch.Tensor) -> torch.Tensor:
        return self.properties(frequency)[0]

    def conductivity(self, frequency: torch.Tensor) -> torch.Tensor:
        return self.properties(frequency)[1]


# ITU-R P.2040-4 Table 3 coefficients (public standard data).
_ITU_MATERIALS_TABLE: dict[str, tuple[ItuRow, ...]] = {
    "Vacuum": ((1.0, 0.0, 0.0, 0.0, None),),
    "Concrete": (
        (5.24, 0.0, 0.0462, 0.7822, (1.0, 100.0)),
        (5.17, 0.0, 0.0145, 1.09, (110.0, 330.0)),
    ),
}

materials = {name: Material(name, rows) for name, rows in _ITU_MATERIALS_TABLE.items()}
"""Built-in ITU radio materials: the subset the coverage path names so far
(``Vacuum`` is the default of a mesh without materials)."""
