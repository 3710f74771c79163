"""Interaction types (port of ``differt_tpu.em._interaction_type``)."""

from enum import IntEnum


class InteractionType(IntEnum):
    """Type of a ray-object interaction, stored as plain integers in ``interaction_types``.

    >>> int(InteractionType.REFLECTION), int(InteractionType.DIFFRACTION)
    (0, 1)
    >>> InteractionType(2).name
    'SCATTERING'
    """

    REFLECTION = 0
    """Specular reflection."""
    DIFFRACTION = 1
    """Edge diffraction."""
    SCATTERING = 2
    """Diffuse scattering."""
