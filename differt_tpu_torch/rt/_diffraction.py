"""First-order edge diffraction: tracing and UTD field composition (PyTorch port of ``differt_tpu.rt._diffraction``).

- The diffraction point on an (infinite) edge line has a closed form from
  the Keller condition (equal angles with the edge):
  ``t* = (a_par * b_perp + b_par * a_perp) / (a_perp + b_perp)``, so
  single-diffraction paths need no iterative solve and are traced for
  every TX x RX x edge at once.
- Validity: the point lies inside the finite edge, neither sub-segment is
  blocked (the any-hit dispatch: the hand-written kernel on CUDA tensors)
  and neither is degenerate.
- :func:`diffraction_amplitudes` composes the UTD coefficients into complex
  channel amplitudes in the edge-fixed frames, with the spherical-wave
  spreading factor ``sqrt(s_i / (s_d (s_i + s_d)))``.
"""

import dataclasses
import math

import torch

from ..em._interaction_type import InteractionType
from ..geometry._paths import TracedPaths
from ..geometry._vectors import _cross, _dot, normalize
from ..rt._triangle import F32_EPS


def diffraction_point_on_edge(
    from_vertex: torch.Tensor,
    to_vertex: torch.Tensor,
    edge_origin: torch.Tensor,
    edge_vector: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimum-length (Keller) point on an infinite edge line, and its parameter.

    All inputs broadcast over ``[*batch, 3]``. ``t`` is in units of
    ``edge_vector``, so ``0 <= t <= 1`` means inside the finite segment.
    Symmetric endpoints diffract at the edge's midpoint:

    >>> import torch
    >>> point, t = diffraction_point_on_edge(
    ...     torch.tensor([-1.0, -1.0, 0.0]),
    ...     torch.tensor([1.0, 1.0, 0.0]),
    ...     torch.tensor([-1.0, 1.0, 0.0]),
    ...     torch.tensor([2.0, -2.0, 0.0]),
    ... )
    >>> [round(v, 3) + 0.0 for v in point.tolist()], round(float(t), 3)
    ([0.0, 0.0, 0.0], 0.5)
    """
    e_hat, e_len = normalize(edge_vector, keepdims=True)
    a = from_vertex - edge_origin
    b = to_vertex - edge_origin
    a_par = _dot(a, e_hat)
    b_par = _dot(b, e_hat)
    a_perp = torch.linalg.vector_norm(a - a_par[..., None] * e_hat, dim=-1)
    b_perp = torch.linalg.vector_norm(b - b_par[..., None] * e_hat, dim=-1)

    denom = a_perp + b_perp
    s = torch.where(
        denom > 0.0,
        (a_par * b_perp + b_par * a_perp) / torch.where(denom > 0, denom, 1.0),
        0.5 * (a_par + b_par),
    )
    point = edge_origin + s[..., None] * e_hat
    t = s / torch.where(e_len == 0, 1.0, e_len)[..., 0]
    return point, t


@dataclasses.dataclass(frozen=True)
class DiffractionPathTracer:
    """First-order diffraction tracer over all the mesh's diffraction edges."""

    epsilon: float | None = None
    """Tolerance of ray / object intersection checks (the closed-form point needs none; kept for the reference's signature)."""
    hit_tol: float | None = None
    """Hit-distance tolerance of the blockage test."""
    min_len: float | None = None
    """Smallest squared segment length of a valid path."""

    def trace_paths(self, scene) -> TracedPaths:
        """One-diffraction paths for every TX, RX and edge, of batch shape ``[num_tx, num_rx, num_edges]``.

        ``objects`` holds ``[tx_index, edge_index, rx_index]`` per path;
        ``edge_index`` indexes ``scene.mesh.diffraction_edges``.
        """
        mesh = scene.mesh if scene.mesh.assume_unique_vertices else scene.mesh.dedup_vertices()
        edges, _, _ = mesh._diffraction_edges_info()
        return _trace_diffraction(
            mesh,
            scene.transmitters.reshape(-1, 3),
            scene.receivers.reshape(-1, 3),
            edges,
            hit_tol=self.hit_tol,
            min_len=self.min_len,
        )


def keller_paths(
    tx_vertices: torch.Tensor, rx_vertices: torch.Tensor, edges: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The paths ``[num_tx, num_rx, num_edges, 3, 3]`` from each TX through the Keller point of each edge to each RX, and the points' edge parameters ``t``."""
    shape = (tx_vertices.shape[0], rx_vertices.shape[0], edges.shape[0])
    tx = tx_vertices[:, None, None, :]
    rx = rx_vertices[None, :, None, :]
    point, t = diffraction_point_on_edge(tx, rx, edges[:, 0, :], edges[:, 1, :] - edges[:, 0, :])
    return torch.stack((tx.expand(*shape, 3), point, rx.expand(*shape, 3)), dim=-2), t


def _trace_diffraction(
    mesh,
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    edges: torch.Tensor,
    *,
    hit_tol: float | None,
    min_len: float | None,
) -> TracedPaths:
    """The paths ``[num_tx, num_rx, num_edges]`` through the Keller point of each ``[num_edges, 2, 3]`` edge.

    One any-hit call holds all ``2 * num_tx * num_rx * num_edges``
    segments: dense, as in the reference.
    """
    if min_len is None:
        min_len = 10.0 * F32_EPS
    shape = (tx_vertices.shape[0], rx_vertices.shape[0], edges.shape[0])
    device = tx_vertices.device

    full_paths, t = keller_paths(tx_vertices, rx_vertices, edges)
    # Inside the finite edge, with a margin that keeps the point off the
    # corners, where the wedge is ill-defined.
    margin = 1e-4
    on_segment = (t > margin) & (t < 1.0 - margin)

    ray_origins = full_paths[..., :-1, :]
    ray_directions = full_paths[..., 1:, :] - full_paths[..., :-1, :]
    blocked = mesh.ray_intersect_any_triangle(ray_origins, ray_directions, hit_tol=hit_tol).any(dim=-1)
    seg_sq = (ray_directions * ray_directions).sum(dim=-1)
    too_small = (seg_sq < min_len).any(dim=-1)

    is_finite = torch.isfinite(full_paths).all(dim=-1).all(dim=-1)
    full_paths = torch.where(is_finite[..., None, None], full_paths, 0.0)
    mask = on_segment & ~blocked & ~too_small & is_finite

    def index(n: int, axis: int) -> torch.Tensor:
        view = [1, 1, 1]
        view[axis] = n
        return torch.arange(n, device=device).reshape(view).expand(shape)

    objects = torch.stack((index(shape[0], 0), index(shape[2], 2), index(shape[1], 1)), dim=-1)
    interaction_types = torch.full(
        (*shape, 1), int(InteractionType.DIFFRACTION), dtype=torch.int32, device=device
    )
    return TracedPaths(full_paths, objects, mask=mask, interaction_types=interaction_types)


def _face_tangent(
    triangle_centroid: torch.Tensor, edge_origin: torch.Tensor, e_hat: torch.Tensor
) -> torch.Tensor:
    """Unit vector perpendicular to the edge, in the face, pointing inward."""
    to_centroid = triangle_centroid - edge_origin
    par = _dot(to_centroid, e_hat)[..., None]
    return normalize(to_centroid - par * e_hat)[0]


def diffraction_amplitudes(
    paths: TracedPaths,
    scene,
    frequency,
    *,
    edges: torch.Tensor,
    adjacent_triangles: torch.Tensor,
    wedge_n: torch.Tensor,
    eta_r=None,
    conductivity=None,
) -> torch.Tensor:
    """Complex channel amplitude of first-order diffraction paths (V polarization), ``[*batch]``.

    The UTD recipe: edge-fixed incident and diffracted frames, the soft and
    hard coefficients applied in the edge-fixed basis, the spherical-wave
    distance parameter ``L = s_i s_d sin^2(beta_0) / (s_i + s_d)`` and the
    spreading factor ``sqrt(s_i / (s_d (s_i + s_d)))``. With ``eta_r`` and
    ``conductivity`` (per material) the wedge's faces are lossy (the
    Luebbers heuristic: each face's Fresnel coefficients at its grazing
    angle); otherwise they are perfectly conducting. ``edges``,
    ``adjacent_triangles`` and ``wedge_n`` are
    ``Mesh._diffraction_edges_info()`` of the (deduplicated) scene mesh.

    The per-edge quantities form one ``[num_edges, C]`` table, gathered per
    path with :func:`~differt_tpu_torch.utils.gather_columns`; the vector
    algebra runs on component tuples of batch-shaped tensors.
    """
    from ..em._constants import c, epsilon_0
    from ..em._fresnel import reflection_coefficients
    from ..em._utd import diffraction_coefficients
    from ..utils import (
        cross3,
        dot3,
        gather_columns,
        normalize3,
        safe_divide,
        spherical3,
        unpack_vertices3,
    )

    device = paths.vertices.device
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=device)
    # True divisions: `scalar / tensor` is a reciprocal and a product in
    # PyTorch, an ulp off the quotient, and k times a path of tens of metres
    # turns an ulp of k into 2e-4 of the phase.
    wavelength = frequency.new_tensor(c) / frequency
    k_wave = frequency.new_tensor(2.0 * math.pi) / wavelength

    # The per-edge table.
    edge_origin_t = edges[:, 0, :]
    e_hat_t = normalize(edges[:, 1, :] - edge_origin_t)[0]
    o_face = adjacent_triangles[:, 0].clamp(min=0)
    n_face = adjacent_triangles[:, 1].clamp(min=0)
    mesh = scene.mesh
    c_o = mesh.triangle_vertices.mean(dim=-2)[o_face]
    n_o_t = mesh.normals[o_face]
    t_o_t = _face_tangent(c_o, edge_origin_t, e_hat_t)
    # Orient the edge so that (t_o, n_o, e_hat) is right-handed: azimuths
    # measured from t_o toward n_o then sweep through the wedge's exterior.
    flip = _dot(_cross(t_o_t, n_o_t), e_hat_t) < 0.0
    e_hat_t = torch.where(flip[:, None], -e_hat_t, e_hat_t)

    lossy = eta_r is not None and conductivity is not None
    columns = [e_hat_t, t_o_t, n_o_t, wedge_n[:, None]]
    if lossy:
        eta_r = torch.as_tensor(eta_r, dtype=torch.float32, device=device)
        conductivity = torch.as_tensor(conductivity, dtype=torch.float32, device=device)
        omega = 2.0 * math.pi * frequency
        n_complex = torch.sqrt(eta_r - 1j * conductivity / (omega * epsilon_0))
        if mesh.face_materials is None:
            n_r_o_t = n_complex[0].expand(o_face.shape)
            n_r_n_t = n_r_o_t
        else:
            # Clamped, as in coverage.complex_amplitudes.
            mats = mesh.face_materials.clamp(0, n_complex.shape[0] - 1)
            n_r_o_t = n_complex[mats[o_face]]
            n_r_n_t = n_complex[mats[n_face]]
        columns += [
            n_r_o_t.real[:, None],
            n_r_o_t.imag[:, None],
            n_r_n_t.real[:, None],
            n_r_n_t.imag[:, None],
        ]
    table = torch.cat([col.to(torch.float32) for col in columns], dim=-1)

    # The batch side, component-wise.
    valid = paths.valid_mask
    tx, qd, rx = unpack_vertices3(paths.vertices, valid)
    k_i, s_i = normalize3(tuple(qd[a] - tx[a] for a in range(3)))
    k_d, s_d = normalize3(tuple(rx[a] - qd[a] for a in range(3)))

    cols = gather_columns(table, paths.objects[..., 1])
    e_hat = (cols[0], cols[1], cols[2])
    t_o = (cols[3], cols[4], cols[5])
    n_o = (cols[6], cols[7], cols[8])
    n_param = cols[9]

    # The skew angle (the Keller cone's half angle).
    cos_beta = dot3(k_i, e_hat)
    sin_beta_0 = torch.sqrt(torch.clamp(1.0 - cos_beta * cos_beta, 1e-12, 1.0))

    def azimuth(v):
        """Angle of ``v`` (projected across the edge) from the o-face, through the exterior, in [0, 2 pi)."""
        par = dot3(v, e_hat)
        perp = normalize3(tuple(v[a] - par * e_hat[a] for a in range(3)))[0]
        ang = torch.atan2(dot3(perp, n_o), dot3(perp, t_o))
        return torch.where(ang < 0.0, ang + 2.0 * math.pi, ang)

    phi_i = azimuth(tuple(-comp for comp in k_i))
    phi_d = azimuth(k_d)
    length = s_i * s_d * sin_beta_0 * sin_beta_0 / (s_i + s_d)

    r_o = r_n = None
    if lossy:
        # Luebbers: the o-face at the incident grazing angle phi', the
        # n-face at the diffracted one (n pi - phi); the Fresnel
        # coefficients take the cosine from the normal, the grazing sine.
        r_o = reflection_coefficients(torch.complex(cols[10], cols[11]), torch.abs(torch.sin(phi_i)))
        r_n = reflection_coefficients(
            torch.complex(cols[12], cols[13]), torch.abs(torch.sin(n_param * math.pi - phi_d))
        )

    d_s, d_h = diffraction_coefficients(
        k=k_wave,
        n=n_param,
        phi_i=phi_i,
        phi_d=phi_d,
        sin_beta_0=sin_beta_0,
        length_i=length,
        r_o=r_o,
        r_n=r_n,
    )

    # Edge-fixed frames.
    phi_i_hat = normalize3(cross3(e_hat, k_i))[0]
    beta_i_hat = normalize3(cross3(phi_i_hat, k_i))[0]
    phi_d_hat = normalize3(cross3(e_hat, k_d))[0]
    beta_d_hat = normalize3(cross3(phi_d_hat, k_d))[0]

    # The incoming V-pol field in the first segment's spherical frame, times
    # diag(D_s, D_h) in the edge-fixed basis (the conventional leading
    # minus is in the coefficients' common factor).
    theta_in, _ = spherical3(k_i)
    e_beta = d_s * dot3(theta_in, beta_i_hat).to(torch.complex64)
    e_phi = d_h * dot3(theta_in, phi_i_hat).to(torch.complex64)

    # Onto the receiver's V polarization.
    theta_out, _ = spherical3(k_d)
    theta_neg = spherical3(tuple(-comp for comp in k_d))[0]
    u = dot3(theta_out, theta_neg)
    a = u * (e_beta * dot3(theta_out, beta_d_hat) + e_phi * dot3(theta_out, phi_d_hat))

    # Spherical-wave spreading (the incident 1/s_i folded in) and the phase
    # over the whole path.
    one = torch.ones_like(s_i)
    spreading = safe_divide(one, s_i) * torch.sqrt(safe_divide(s_i, s_d * (s_i + s_d)))
    phase = -k_wave * (s_i + s_d)
    a = a * spreading * torch.complex(torch.cos(phase), torch.sin(phase))
    a = a * (wavelength / (4.0 * math.pi))
    return a * paths.mask.to(torch.float32)
