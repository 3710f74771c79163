"""Electromagnetic constants, Fresnel coefficients and materials."""

from ._constants import c, epsilon_0, mu_0, z_0
from ._fresnel import reflection_coefficients, slab_reflection_coefficients
from ._material import Material, materials

__all__ = (
    "Material",
    "c",
    "epsilon_0",
    "materials",
    "mu_0",
    "reflection_coefficients",
    "slab_reflection_coefficients",
    "z_0",
)
