"""Electromagnetics: constants, Fresnel coefficients, materials, antennas, polarization frames, delays and UTD diffraction."""

from ._antenna import (
    Antenna,
    BaseAntenna,
    Dipole,
    HWDipolePattern,
    RadiationPattern,
    ShortDipole,
    ShortDipolePattern,
    poynting_vector,
)
from ._constants import c, epsilon_0, mu_0, z_0
from ._fresnel import (
    fresnel_coefficients,
    reflection_coefficients,
    refraction_coefficients,
    refractive_index,
    slab_reflection_coefficients,
)
from ._interaction_type import InteractionType
from ._material import ItuProperties, Material, MaterialsDict, materials
from ._utd import F, L_i, diffraction_coefficients, fresnel
from ._utils import (
    fspl,
    length_to_delay,
    path_delay,
    sp_directions,
    sp_rotation_matrix,
    spherical_basis,
    transition_apply,
    transition_matrix,
)

__all__ = (
    "F",
    "L_i",
    "Antenna",
    "BaseAntenna",
    "Dipole",
    "HWDipolePattern",
    "InteractionType",
    "ItuProperties",
    "Material",
    "MaterialsDict",
    "RadiationPattern",
    "ShortDipole",
    "ShortDipolePattern",
    "c",
    "diffraction_coefficients",
    "epsilon_0",
    "fresnel",
    "fresnel_coefficients",
    "fspl",
    "length_to_delay",
    "materials",
    "mu_0",
    "path_delay",
    "poynting_vector",
    "reflection_coefficients",
    "refraction_coefficients",
    "refractive_index",
    "slab_reflection_coefficients",
    "sp_directions",
    "sp_rotation_matrix",
    "spherical_basis",
    "transition_apply",
    "transition_matrix",
    "z_0",
)
