"""ITU-R P.2040-4 materials (PyTorch port of ``differt_tpu.em._material``).

Relative permittivity is ``a * f_GHz**b`` and conductivity ``c * f_GHz**d``
in each frequency range; outside every range both are -1. The first range
(sorted by lower bound) that contains the frequency wins. The table
resolves names and their ``itu_*`` aliases (:class:`MaterialsDict`).
"""

import dataclasses
import math
from collections.abc import Iterable, Mapping
from typing import Any

import torch

# (a, b, c, d, (f_min_GHz, f_max_GHz) | None)
ItuProperties = tuple[float, float, float, float, "tuple[float, float] | None"]


@dataclasses.dataclass(frozen=True)
class Material:
    """A material with frequency-dependent electrical properties.

    >>> import torch
    >>> round(float(materials["itu_concrete"].relative_permittivity(torch.tensor(3e9))), 2)
    5.24
    >>> materials["itu_concrete"].name
    'Concrete'
    """

    name: str
    rows: tuple[ItuProperties, ...]
    thickness: float | None = None
    """Slab thickness (m); None: semi-infinite."""
    aliases: tuple[str, ...] = ()
    """Other names of the material (Sionna's ``itu_*``)."""

    @classmethod
    def from_itu_properties(cls, name: str, *rows: ItuProperties) -> "Material":
        """A material from ITU-R P.2040-4 ``(a, b, c, d, f_range_GHz)`` rows, aliased ``itu_<name>``.

        A catch-all row (a range of None) cannot sit beside other rows.
        """
        if len(rows) > 1 and any(r[4] is None for r in rows):
            msg = (
                "A catch-all range (frequency bounds of 'None') cannot be"
                " combined with other ranges: it would shadow them."
            )
            raise ValueError(msg)
        alias = f"itu_{name.lower().replace(' ', '_')}"
        return cls(name, tuple(rows), aliases=(alias,))

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


class MaterialsDict(dict):
    """A dict of materials that also resolves each material's aliases.

    >>> table = MaterialsDict([Material.from_itu_properties("Wood", (1.99, 0.0, 0.0047, 1.0718, (0.001, 100.0)))])
    >>> "itu_wood" in table, table["itu_wood"].name
    (True, 'Wood')
    """

    def __init__(
        self,
        other: Mapping[str, Material] | Iterable[Material | tuple[str, Material]] = (),
        /,
        **kwargs: Material,
    ) -> None:
        super().__init__()
        self.update(other, **kwargs)

    def _resolve(self, key: Any) -> Any:
        if not isinstance(key, str) or super().__contains__(key):
            return key
        return next((name for name, mat in self.items() if key in mat.aliases), key)

    def __missing__(self, key: str) -> Material:
        real = self._resolve(key)
        if real == key:
            raise KeyError(key)
        return self[real]

    def __contains__(self, key: object) -> bool:
        return super().__contains__(self._resolve(key))

    def __delitem__(self, key: str) -> None:
        super().__delitem__(self._resolve(key))

    def __setitem__(self, key: str, value: Material) -> None:
        real = self._resolve(key)
        if super().__contains__(real):
            super().__setitem__(real, value)
        elif isinstance(value, Material):
            super().__setitem__(value.name, value)
        else:
            super().__setitem__(key, value)

    def get(self, key: object, default: Any = None) -> Any:
        return super().get(self._resolve(key), default)

    def pop(self, key: object, *default: Any) -> Any:
        real = self._resolve(key)
        if super().__contains__(real):
            return super().pop(real)
        if default:
            return default[0]
        raise KeyError(key)

    def setdefault(self, key: str, default: Any = None) -> Any:
        real = self._resolve(key)
        if super().__contains__(real):
            return self[real]
        self[key] = default
        return default

    def update(self, other: Any = (), /, **kwargs: Material) -> None:
        items = other.items() if isinstance(other, Mapping) else other
        for item in items:
            if isinstance(item, Material):
                self[item.name] = item
            else:
                key, value = item
                self[key] = value
        for key, value in kwargs.items():
            self[key] = value


# ITU-R P.2040-4 Table 3 coefficients (public standard data).
_ITU_MATERIALS_TABLE: dict[str, tuple[ItuProperties, ...]] = {
    "Vacuum": ((1.0, 0.0, 0.0, 0.0, None),),
    "Concrete": (
        (5.24, 0.0, 0.0462, 0.7822, (1.0, 100.0)),
        (5.17, 0.0, 0.0145, 1.09, (110.0, 330.0)),
    ),
    "Brick": (
        (3.91, 0.0, 0.0238, 0.16, (1.0, 40.0)),
        (3.75, 0.0, 0.038, 0.0, (1.0, 10.0)),
        (3.95, 0.0, 0.0022, 1.33, (100.0, 400.0)),
    ),
    "Plasterboard": (
        (2.94, 0.0, 0.0116, 0.7076, (1.0, 100.0)),
        (2.73, 0.0, 0.0084, 0.94, (100.0, 400.0)),
    ),
    "Wood": (
        (1.99, 0.0, 0.0047, 1.0718, (0.001, 100.0)),
        (1.63, 0.0, 0.0076, 1.002, (100.0, 400.0)),
    ),
    "Glass": (
        (6.27, 0.0, 0.0043, 1.1925, (0.1, 100.0)),
        (6.70, 0.0, 0.0042, 1.15, (100.0, 400.0)),
        (6.01, 0.0, 0.0400, 0.81, (220.0, 450.0)),
    ),
    "Clear Acrylic": ((2.57, 0.0, 0.0049, 1.0601, (1.0, 40.0)),),
    "Ceiling board": (
        (1.48, 0.0, 0.0011, 1.1278, (1.0, 100.0)),
        (1.58, 0.0, 0.0014, 1.07, (100.0, 400.0)),
    ),
    "Chipboard": (
        (2.58, 0.0, 0.0217, 0.7800, (1.0, 100.0)),
        (2.16, 0.0, 0.0023, 1.359, (100.0, 200.0)),
    ),
    "Plywood": (
        (2.71, 0.0, 0.33, 0.0, (1.0, 40.0)),
        (1.94, 0.0, 0.0067, 0.9982, (110.0, 330.0)),
        (2.17, 0.0, 0.0063, 1.045, (100.0, 400.0)),
    ),
    "Marble": (
        (7.074, 0.0, 0.0055, 0.9262, (1.0, 60.0)),
        (7.94, 0.0, 0.0001, 1.7330, (110.0, 330.0)),
        (8.62, 0.0, 0.0027, 1.15, (100.0, 400.0)),
    ),
    "Floorboard": (
        (3.66, 0.0, 0.0044, 1.3515, (50.0, 100.0)),
        (5.27, 0.0, 2.22e-17, 7.3413, (220.0, 300.0)),
        (5.27, 0.0, 0.0003, 2.0298, (300.0, 400.0)),
        (5.27, 0.0, 49.8726, 0.0, (400.0, 450.0)),
        (3.1575, 0.0, 0.001675, 1.32775, (100.0, 400.0)),
    ),
    "Vinyl tile": ((3.62, 0.0, 0.0051, 0.8422, (1.0, 40.0)),),
    "Carpet tile": ((2.08, 0.0, 0.0009, 0.8200, (1.0, 40.0)),),
    "Asphalt concrete": ((4.83, 0.0, 0.0108, 1.3969, (1.0, 40.0)),),
    "Metal": ((1.0, 0.0, 1e7, 0.0, (1.0, 100.0)),),
    "Very dry ground": ((3.0, 0.0, 0.00015, 2.52, (1.0, 10.0)),),
    "Medium dry ground": ((15.0, -0.1, 0.035, 1.63, (1.0, 10.0)),),
    "Wet ground": ((30.0, -0.4, 0.15, 1.30, (1.0, 10.0)),),
}

materials: MaterialsDict = MaterialsDict(
    Material.from_itu_properties(name, *rows) for name, rows in _ITU_MATERIALS_TABLE.items()
)
"""Built-in ITU radio materials, by name or ``itu_*`` alias (``Vacuum`` is the default of a mesh without materials)."""
