"""Diffuse scattering: single-bounce scattered paths and effective-roughness fields (PyTorch port of ``differt_tpu.rt._scattering``).

Every triangle scatters from a set of sample points (its centroid for
``num_samples=1``, an R2 low-discrepancy pattern folded into the triangle
otherwise), each weighted by its share of the triangle's area. The field is
the Degli-Esposti *effective roughness* model:

- a scattering coefficient ``S`` in [0, 1], the fraction of the incident
  field amplitude scattered diffusely (the specular reflections are then
  scaled by ``sqrt(1 - S^2)``, which is left to the caller:
  :func:`~differt_tpu_torch.coverage.power_map` does it);
- a pattern: Lambertian ``cos(theta_s) / pi``, or the directive lobe
  ``((1 + cos(psi)) / 2)^alpha_r`` around the specular direction, divided
  by its hemisphere integral;
- the scattered power of a patch ``dA``:
  ``S^2 |R|^2 cos(theta_i) dA f(theta_s) / (r_i^2 r_s^2)`` with ``|R|^2``
  the mean of the s and p power reflection coefficients.

The amplitudes carry the deterministic propagation phase
``exp(-j k (r_i + r_s))``; their power adds incoherently in the maps.
"""

import dataclasses
import math

import torch

from ..em._interaction_type import InteractionType
from ..geometry._paths import TracedPaths
from ..geometry._vectors import _cross, _dot
from ..utils import safe_divide
from ._triangle import F32_EPS

# The plastic constant, the R2 sequence's generator.
_PLASTIC = 1.32471795724474602596


def triangle_sample_points(triangle_vertices: torch.Tensor, num_samples: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Sample points ``[*batch, num_samples, 3]`` on ``[*batch, 3, 3]`` triangles and their area weights ``[*batch, num_samples]``.

    ``num_samples=1`` gives the centroids; more samples follow the R2
    low-discrepancy sequence, folded onto each triangle, and share its area.

    >>> import torch
    >>> tri = torch.tensor([[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]])
    >>> points, weights = triangle_sample_points(tri)
    >>> [round(float(x), 4) for x in points[0, 0]], float(weights[0, 0])  # the centroid and the area
    ([0.3333, 0.3333, 0.0], 0.5)
    >>> points, weights = triangle_sample_points(tri, num_samples=4)
    >>> tuple(points.shape), round(float(weights.sum()), 4)
    ((1, 4, 3), 0.5)
    """
    triangle_vertices = torch.as_tensor(triangle_vertices)
    a = triangle_vertices[..., 0, :]
    b = triangle_vertices[..., 1, :]
    c = triangle_vertices[..., 2, :]
    area = 0.5 * torch.linalg.vector_norm(_cross(b - a, c - a), dim=-1)
    if num_samples == 1:
        return ((a + b + c) / 3.0)[..., None, :], area[..., None]

    # The R2 sequence in the unit square (in the triangles' dtype), folded
    # onto the triangle: uniform either way.
    dtype = triangle_vertices.dtype
    i = torch.arange(num_samples, dtype=dtype, device=triangle_vertices.device) + 0.5
    u = torch.remainder(i / torch.tensor(_PLASTIC, dtype=dtype), 1.0)
    v = torch.remainder(i / torch.tensor(_PLASTIC * _PLASTIC, dtype=dtype), 1.0)
    over = u + v > 1.0
    u = torch.where(over, 1.0 - u, u)
    v = torch.where(over, 1.0 - v, v)
    points = a[..., None, :] + u[:, None] * (b - a)[..., None, :] + v[:, None] * (c - a)[..., None, :]
    weights = (area / num_samples)[..., None].expand(*area.shape, num_samples)
    return points, weights


@dataclasses.dataclass(frozen=True)
class ScatteringPathTracer:
    """Single-bounce diffuse scattering tracer.

    One path per (TX, RX, triangle, sample point), of type
    ``InteractionType.SCATTERING``; a path is valid with the TX and the RX
    in front of the surface and both segments unblocked.
    """

    hit_tol: float | None = None
    """Hit-distance tolerance of the blockage test."""
    min_len: float | None = None
    """Smallest squared segment length of a valid path."""
    num_samples: int = 1
    """Scattering sample points per triangle."""

    def trace_paths(self, scene) -> TracedPaths:
        """The scattered paths, of batch shape ``[num_tx, num_rx, num_triangles * num_samples]``.

        ``objects`` holds ``[tx, triangle_index, rx]``; with ``num_samples
        > 1`` each triangle index repeats once per sample.
        """
        if scene.mesh.assume_quads:
            msg = "ScatteringPathTracer requires a triangle mesh."
            raise ValueError(msg)
        return _trace_scattering(
            scene.mesh,
            scene.transmitters.reshape(-1, 3),
            scene.receivers.reshape(-1, 3),
            num_samples=self.num_samples,
            hit_tol=self.hit_tol,
            min_len=self.min_len,
        )


def _trace_scattering(
    mesh,
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    *,
    num_samples: int,
    hit_tol: float | None,
    min_len: float | None,
) -> TracedPaths:
    """The paths ``[num_tx, num_rx, num_points]`` through each sample point; one any-hit call holds both segments of every path."""
    if min_len is None:
        min_len = 10.0 * F32_EPS
    num_tx, num_rx = tx_vertices.shape[0], rx_vertices.shape[0]
    device = tx_vertices.device

    points, _ = triangle_sample_points(mesh.triangle_vertices, num_samples)
    points = points.reshape(-1, 3)
    num_points = points.shape[0]
    shape = (num_tx, num_rx, num_points)
    tri_index = torch.arange(mesh.num_triangles, dtype=torch.int32, device=device).repeat_interleave(num_samples)
    normals = mesh.normals[tri_index]

    tx = tx_vertices[:, None, None, :]
    rx = rx_vertices[None, :, None, :]
    full_paths = torch.stack((tx.expand(*shape, 3), points.expand(*shape, 3), rx.expand(*shape, 3)), dim=-2)
    ray_origins = full_paths[..., :-1, :]
    segments = full_paths[..., 1:, :] - full_paths[..., :-1, :]

    # In front: both ends above the surface's plane.
    front = (_dot(tx - points, normals) > 0.0) & (_dot(rx - points, normals) > 0.0)
    blocked = mesh.ray_intersect_any_triangle(ray_origins, segments, hit_tol=hit_tol).any(dim=-1)
    too_small = ((segments * segments).sum(dim=-1) < min_len).any(dim=-1)
    mask = front & ~blocked & ~too_small
    if mesh.mask is not None:
        mask = mask & mesh.mask[tri_index]

    objects = torch.stack(
        (
            torch.arange(num_tx, dtype=torch.int32, device=device)[:, None, None].expand(shape),
            tri_index.expand(shape),
            torch.arange(num_rx, dtype=torch.int32, device=device)[None, :, None].expand(shape),
        ),
        dim=-1,
    )
    interaction_types = torch.full(
        (*shape, 1), int(InteractionType.SCATTERING), dtype=torch.int32, device=device
    )
    return TracedPaths(full_paths, objects, mask=mask, interaction_types=interaction_types)


def directive_pattern_normalization(alpha_r: int, cos_theta_i) -> torch.Tensor:
    r"""Hemisphere integral of the directive lobe ``((1 + cos(psi)) / 2)^alpha_r``.

    The closed form of Degli-Esposti et al., "Measurement and modelling of
    scattering from buildings", IEEE Trans. AP 55(1), 2007, eqs. (9)-(11),
    for a lobe axis (the specular direction) ``theta_i`` from the normal:

    .. math::
        F_{\alpha} = \frac{1}{2^{\alpha}} \sum_{j=0}^{\alpha}
        \binom{\alpha}{j} I_j,\qquad
        I_j = \frac{2\pi}{j+1} \times \begin{cases}
        1 & j\ \text{even}\\
        \cos\theta_i \sum_{w=0}^{(j-1)/2} \binom{2w}{w}
        \big(\tfrac{\sin^2\theta_i}{4}\big)^w & j\ \text{odd}
        \end{cases}

    Dividing the lobe by ``F_alpha`` makes the scattered power integrate to
    the ``S^2`` budget at every incidence angle.

    >>> import math, torch
    >>> f1 = directive_pattern_normalization(1, torch.tensor(1.0))
    >>> bool(torch.isclose(f1, torch.tensor(4.0 * math.pi / 2.0 * 0.75)))  # 1.5 pi at normal incidence
    True
    """
    cos_theta_i = torch.as_tensor(cos_theta_i)
    sin_sq = torch.clamp(1.0 - cos_theta_i**2, 0.0, 1.0)
    total = torch.zeros_like(cos_theta_i)
    for j in range(alpha_r + 1):
        if j % 2 == 0:
            i_j = torch.full_like(cos_theta_i, 2.0 * math.pi / (j + 1.0))
        else:
            series = torch.zeros_like(cos_theta_i)
            for w in range((j - 1) // 2 + 1):
                series = series + math.comb(2 * w, w) * (sin_sq / 4.0) ** w
            i_j = (2.0 * math.pi / (j + 1.0)) * cos_theta_i * series
        total = total + math.comb(alpha_r, j) * i_j
    return total / (2.0**alpha_r)


def scattering_amplitudes(
    paths: TracedPaths,
    scene,
    frequency,
    *,
    eta_r,
    conductivity,
    scattering_coefficient=0.3,
    alpha_r: int | None = None,
    num_samples: int = 1,
) -> torch.Tensor:
    """Complex amplitude of single-bounce scattered paths (effective roughness), ``[*batch]``, zero where invalid.

    ``paths`` come from :class:`ScatteringPathTracer` (with the same
    ``num_samples``, for the area weights). ``eta_r``, ``conductivity``
    and ``scattering_coefficient`` (``S``; a scalar broadcasts) are per
    material. ``alpha_r`` is ``None`` for the Lambertian pattern, else the
    directive lobe's exponent. The power ``|a|^2`` is the physical
    quantity; the phases are the deterministic propagation phases.

    The per-triangle quantities (normal, area, refractive index, ``S``)
    form one table, gathered per path with
    :func:`~differt_tpu_torch.utils.gather_columns`.
    """
    from ..em._constants import c, epsilon_0
    from ..em._fresnel import reflection_coefficients
    from ..utils import dot3, gather_columns, normalize3, unpack_vertices3

    device = paths.vertices.device
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=device)
    # True divisions: see diffraction_amplitudes.
    wavelength = frequency.new_tensor(c) / frequency
    k_wave = frequency.new_tensor(2.0 * math.pi) / wavelength
    eta_r = torch.atleast_1d(torch.as_tensor(eta_r, dtype=torch.float32, device=device))
    conductivity = torch.atleast_1d(torch.as_tensor(conductivity, dtype=torch.float32, device=device))
    s_coeff = torch.atleast_1d(torch.as_tensor(scattering_coefficient, dtype=torch.float32, device=device))
    s_coeff = s_coeff.expand(eta_r.shape)
    omega = 2.0 * math.pi * frequency
    n_complex = torch.sqrt(eta_r - 1j * conductivity / (omega * epsilon_0))

    tx, q, rx = unpack_vertices3(paths.vertices, paths.valid_mask)
    d_in = tuple(q[a] - tx[a] for a in range(3))
    d_out = tuple(rx[a] - q[a] for a in range(3))
    k_in, k_out = normalize3(d_in)[0], normalize3(d_out)[0]
    # The lengths' roots correctly rounded (in float64): PyTorch's CPU
    # float32 sqrt is an ulp off for some arguments, and k (r_i + r_s),
    # thousands of radians, turns an ulp of r into 5e-4 rad of phase.
    r_i, r_s = (torch.sqrt(dot3(d, d).double()).to(d[0].dtype) for d in (d_in, d_out))

    mesh = scene.mesh
    tv = mesh.triangle_vertices
    area_t = 0.5 * torch.linalg.vector_norm(_cross(tv[:, 1, :] - tv[:, 0, :], tv[:, 2, :] - tv[:, 0, :]), dim=-1)
    if mesh.face_materials is None:
        mats = torch.zeros(tv.shape[0], dtype=torch.int64, device=device)
    else:
        # Clamped: a material beyond the table takes its last entry.
        mats = mesh.face_materials.clamp(0, n_complex.shape[0] - 1)
    n_r_t = n_complex[mats]
    table = torch.cat(
        (
            mesh.normals.to(torch.float32),
            area_t[:, None].to(torch.float32),
            n_r_t.real[:, None],
            n_r_t.imag[:, None],
            s_coeff[mats][:, None],
        ),
        dim=-1,
    )
    cols = gather_columns(table, paths.objects[..., 1])
    normals = (cols[0], cols[1], cols[2])
    d_area = cols[3] / num_samples
    s_val = cols[6]

    cos_theta_i = torch.clamp(-dot3(normals, k_in), 0.0, 1.0)
    cos_theta_s = torch.clamp(dot3(normals, k_out), 0.0, 1.0)
    # The surface's power reflection: the mean of s and p at incidence.
    r_s_c, r_p_c = reflection_coefficients(torch.complex(cols[4], cols[5]), cos_theta_i)
    gamma_sq = 0.5 * (torch.abs(r_s_c) ** 2 + torch.abs(r_p_c) ** 2)

    if alpha_r is None:
        pattern = cos_theta_s / math.pi  # Lambertian: the hemisphere integral is 1
    else:
        k_dot_n = dot3(k_in, normals)
        reflected = tuple(k_in[a] - 2.0 * k_dot_n * normals[a] for a in range(3))
        cos_psi = torch.clamp(dot3(reflected, k_out), -1.0, 1.0)
        pattern = ((1.0 + cos_psi) / 2.0) ** alpha_r / directive_pattern_normalization(alpha_r, cos_theta_i)

    one = torch.ones_like(r_s)
    amp_sq = (
        (s_val**2) * gamma_sq * cos_theta_i * d_area * pattern * safe_divide(one, r_s**2) * safe_divide(one, r_i**2)
    )
    amp = torch.sqrt(amp_sq) * (wavelength / (4.0 * math.pi))
    phase = -k_wave * (r_i + r_s)
    a = amp.to(torch.complex64) * torch.complex(torch.cos(phase), torch.sin(phase))
    return a * paths.mask.to(torch.float32)
