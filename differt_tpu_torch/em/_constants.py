"""Electromagnetic constants (SI units), as in ``differt_tpu.em._constants``."""

c = 299792458.0
"""Speed of light in vacuum (m/s)."""

mu_0 = 1.25663706212e-06
"""Vacuum permeability (H/m)."""

epsilon_0 = 8.8541878128e-12
"""Vacuum permittivity (F/m)."""

z_0 = 376.73031341259
"""Impedance of free space (Ohm)."""
