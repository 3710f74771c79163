"""Multi-bounce paths mixing specular reflections and edge diffractions (PyTorch port of ``differt_tpu.rt._mixed``).

- Candidates come from a closed-form mixed-radix ``index -> candidate``
  decode (:func:`generate_mixed_path_candidates`), one base per interaction
  slot: the triangle count for a reflection, the diffraction-edge count for
  a diffraction.
- Geometry is solved with the Fermat minimizer
  (:func:`~differt_tpu_torch.rt.fermat_path_on_linear_objects`): a plane
  contributes its two in-plane vectors, an edge its direction (and a zero
  vector). At the optimum the specular law holds on every plane and the
  Keller cone condition on every edge; both are checked again, to reject
  non-converged and saddle solutions.
- Validity: reflection points inside their triangles, diffraction points
  inside their finite edges, the specular and Keller residuals, the
  blockage of every segment (one any-hit dispatch: the hand-written kernel
  on CUDA tensors), the minimum segment length, finiteness.
- :func:`mixed_amplitudes` composes the field: slab-aware Fresnel Jones
  blocks at reflections, UTD ``diag(D_s, D_h)`` blocks (Luebbers lossy
  wedges) at diffractions, carried in the per-segment spherical frames,
  with the astigmatic two-radii spreading (exact for one diffraction among
  any number of planar reflections, the usual cascade approximation
  beyond).
"""

import dataclasses
import math
from collections.abc import Sequence

import torch

from ..em._interaction_type import InteractionType
from ..geometry._paths import TracedPaths
from ..geometry._vectors import _cross, _dot, normalize, orthogonal_basis
from ..utils import safe_divide
from ._diffraction import _face_tangent
from ._fermat import fermat_path_on_linear_objects
from ._triangle import F32_EPS

_REFLECTION = int(InteractionType.REFLECTION)
_DIFFRACTION = int(InteractionType.DIFFRACTION)


def count_mixed_path_candidates(slot_sizes: Sequence[int]) -> int:
    """Total number of mixed candidates (the full product of the slot sizes).

    >>> count_mixed_path_candidates([3, 4, 2])
    24
    >>> count_mixed_path_candidates([])  # the empty chain: the single line-of-sight path
    1
    """
    total = 1
    for size in slot_sizes:
        total *= max(int(size), 0)
    return total


def _decode_mixed_range(slot_sizes: tuple[int, ...], start: int, size: int, device) -> torch.Tensor:
    """Decode candidates ``start .. start + size`` of the slot product, ``[size, num_slots]`` int32.

    ``start`` is decoded with Python integers, so a candidate space beyond
    ``2**31`` decodes in ranges with no device integer overflowing.
    """
    num_slots = len(slot_sizes)
    if num_slots == 0 or size == 0 or any(s <= 0 for s in slot_sizes):
        rows = max(size, 0) if all(slot_sizes) else 0
        return torch.zeros((rows, num_slots), dtype=torch.int32, device=device)

    # The weight of slot t is the product of all later slot sizes.
    weights = [1] * num_slots
    for t in reversed(range(num_slots - 1)):
        weights[t] = weights[t + 1] * slot_sizes[t + 1]
    start_digits = []
    rem_start = start
    for t in range(num_slots):
        digit, rem_start = divmod(rem_start, weights[t])
        start_digits.append(digit)

    j = torch.arange(size, dtype=torch.int64, device=device)
    offset_digits = []
    rem = j
    for t in range(num_slots):
        if weights[t] > size:
            offset_digits.append(torch.zeros_like(j))
        else:
            offset_digits.append(rem // weights[t])
            rem = rem % weights[t]

    counters = [None] * num_slots
    carry = torch.zeros_like(j)
    for t in reversed(range(num_slots)):
        base = max(slot_sizes[t], 1)
        total = offset_digits[t] + start_digits[t] + carry
        counters[t] = total % base
        carry = total // base
    return torch.stack(counters, dim=-1).to(torch.int32)


def generate_mixed_path_candidates(
    slot_sizes: Sequence[int],
    *,
    start: int = 0,
    size: int | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Enumerate (a range of) the full product of per-slot indices, ``[size, num_slots]``, on the card unless ``device`` says otherwise.

    Row-major (the last slot varies fastest); ``start`` may be a Python
    big integer.

    >>> generate_mixed_path_candidates((2, 3), start=2, size=3, device="cpu").tolist()
    [[0, 2], [1, 0], [1, 1]]
    """
    if device is None:
        device = torch.device("cuda")
    total = count_mixed_path_candidates(slot_sizes)
    if size is None:
        size = max(total - start, 0)
    return _decode_mixed_range(tuple(int(s) for s in slot_sizes), start, size, device)


def _signature(interactions: Sequence[InteractionType | int]) -> tuple[int, ...]:
    types = tuple(int(t) for t in interactions)
    if any(t not in (_REFLECTION, _DIFFRACTION) for t in types):
        msg = "Only REFLECTION and DIFFRACTION interactions are supported."
        raise ValueError(msg)
    return types


@dataclasses.dataclass(frozen=True)
class MixedPathTracer:
    """Exhaustive tracer for one interaction-type signature.

    ``interactions`` is a sequence of :class:`~differt_tpu_torch.em.InteractionType`
    values: ``(REFLECTION, DIFFRACTION)`` traces every reflect-then-diffract path.
    """

    epsilon: float | None = None
    """Tolerance of the point-in-triangle test."""
    hit_tol: float | None = None
    """Hit-distance tolerance of the blockage test."""
    min_len: float | None = None
    """Smallest squared segment length of a valid path."""
    angle_tol: float = 1e-2
    """Largest specular or Keller residual of a converged Fermat solution."""
    steps: int = 20
    """Newton steps of the Fermat minimizer."""

    def trace_paths(
        self,
        scene,
        interactions: Sequence[InteractionType | int],
        *,
        start: int = 0,
        size: int | None = None,
    ) -> TracedPaths:
        """Every path of the signature, of batch shape ``[num_tx, num_rx, num_candidates]``.

        ``objects`` holds ``[tx, slot indices..., rx]``: reflection slots
        index the mesh's triangles, diffraction slots
        ``scene.mesh.diffraction_edges``. ``start`` and ``size`` restrict
        the candidate range.
        """
        if scene.mesh.assume_quads:
            msg = "MixedPathTracer requires a triangle mesh (assume_quads=False)."
            raise ValueError(msg)
        types = _signature(interactions)
        mesh = scene.mesh if scene.mesh.assume_unique_vertices else scene.mesh.dedup_vertices()
        edges, _, _ = mesh._diffraction_edges_info()
        return self.trace_with_edges(scene, mesh, edges, types, start=start, size=size)

    def trace_with_edges(
        self,
        scene,
        mesh,
        edges: torch.Tensor,
        interactions: Sequence[InteractionType | int],
        *,
        start: int = 0,
        size: int | None = None,
    ) -> TracedPaths:
        """:meth:`trace_paths` on edges already extracted from ``mesh``, the scene's (deduplicated) mesh."""
        types = _signature(interactions)
        slot_sizes = tuple(mesh.num_triangles if t == _REFLECTION else edges.shape[0] for t in types)
        candidates = generate_mixed_path_candidates(slot_sizes, start=start, size=size, device=mesh.device)
        return _trace_mixed(
            mesh,
            scene.transmitters.reshape(-1, 3),
            scene.receivers.reshape(-1, 3),
            edges,
            candidates,
            types,
            epsilon=self.epsilon,
            hit_tol=self.hit_tol,
            min_len=self.min_len,
            angle_tol=self.angle_tol,
            steps=self.steps,
        )


def _linear_objects(mesh, edges: torch.Tensor, candidates: torch.Tensor, is_reflection: list[bool]):
    """Per slot: planes their triangle's first corner and in-plane basis, edges their origin and direction plus a zero vector."""
    origins, vectors = [], []
    for b, reflection in enumerate(is_reflection):
        idx = candidates[:, b]
        if reflection:
            origin = mesh.triangle_vertices[idx, 0, :]
            d1, d2 = orthogonal_basis(mesh.normals[idx])
            vecs = torch.stack((d1, d2), dim=-2)
        else:
            e = edges[idx]
            origin = e[:, 0, :]
            ev = e[:, 1, :] - e[:, 0, :]
            vecs = torch.stack((ev, torch.zeros_like(ev)), dim=-2)
        origins.append(origin)
        vectors.append(vecs)
    return torch.stack(origins, dim=-2), torch.stack(vectors, dim=-3)


def _trace_mixed(
    mesh,
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    edges: torch.Tensor,
    candidates: torch.Tensor,
    types: tuple[int, ...],
    *,
    epsilon: float | None,
    hit_tol: float | None,
    min_len: float | None,
    angle_tol: float,
    steps: int,
) -> TracedPaths:
    """The paths ``[num_tx, num_rx, num_candidates]`` of the ``[num_candidates, order]`` candidates of signature ``types``.

    Three stages: the Fermat points (:func:`_fermat_paths`), the geometric
    checks (:func:`_mixed_checks`), then the blockage and the paths
    (:func:`_blocked_paths`), whose one any-hit call holds every ``(order +
    1) * num_tx * num_rx * num_candidates`` segment: dense, as in the
    reference.
    """
    full_paths = _fermat_paths(mesh, tx_vertices, rx_vertices, edges, candidates, types, steps=steps)
    mask = _mixed_checks(mesh, full_paths, edges, candidates, types, epsilon=epsilon, angle_tol=angle_tol)
    return _blocked_paths(mesh, full_paths, mask, candidates, types, hit_tol=hit_tol, min_len=min_len)


def _fermat_paths(mesh, tx_vertices, rx_vertices, edges, candidates, types, *, steps: int) -> torch.Tensor:
    """The full paths ``[num_tx, num_rx, num_candidates, order + 2, 3]``: TX, the Fermat points, RX."""
    shape = (tx_vertices.shape[0], rx_vertices.shape[0], candidates.shape[0])
    object_origins, object_vectors = _linear_objects(mesh, edges, candidates, [t == _REFLECTION for t in types])
    points = fermat_path_on_linear_objects(
        tx_vertices[:, None, None, :],
        rx_vertices[None, :, None, :],
        object_origins,
        object_vectors,
        steps=steps,
    )
    return torch.cat(
        (tx_vertices[:, None, None, None, :].expand(*shape, 1, 3), points, rx_vertices[None, :, None, None, :].expand(*shape, 1, 3)),
        dim=-2,
    )


def _mixed_checks(mesh, full_paths, edges, candidates, types, *, epsilon: float | None, angle_tol: float) -> torch.Tensor:
    """The geometric validity ``[num_tx, num_rx, num_candidates]`` of each slot's point, blockage aside."""
    if epsilon is None:
        epsilon = 10.0 * F32_EPS
    points = full_paths[..., 1:-1, :]
    k_hat, _ = normalize(full_paths[..., 1:, :] - full_paths[..., :-1, :])
    mask = torch.ones(full_paths.shape[:-2], dtype=torch.bool, device=full_paths.device)
    is_reflection = [t == _REFLECTION for t in types]
    for b in range(candidates.shape[1]):
        idx = candidates[:, b]
        p = points[..., b, :]
        k_in = k_hat[..., b, :]
        k_out = k_hat[..., b + 1, :]
        if is_reflection[b]:
            tri = mesh.triangle_vertices[idx]
            # The barycentric inside test.
            e1 = tri[:, 1, :] - tri[:, 0, :]
            e2 = tri[:, 2, :] - tri[:, 0, :]
            d = p - tri[:, 0, :]
            e11, e22, e12 = _dot(e1, e1), _dot(e2, e2), _dot(e1, e2)
            d1, d2 = _dot(d, e1), _dot(d, e2)
            det = e11 * e22 - e12 * e12
            u = safe_divide(d1 * e22 - d2 * e12, det)
            v = safe_divide(d2 * e11 - d1 * e12, det)
            inside = (u >= -epsilon) & (v >= -epsilon) & (u + v <= 1.0 + epsilon)
            # The specular residual: a saddle or a non-converged solution
            # breaks the reflection law.
            normal = mesh.normals[idx]
            reflected = k_in - 2.0 * _dot(k_in, normal)[..., None] * normal
            residual = torch.linalg.vector_norm(k_out - reflected, dim=-1)
            # Both neighbouring vertices on one side of the plane.
            prev_side = _dot(full_paths[..., b, :] - p, normal)
            next_side = _dot(full_paths[..., b + 2, :] - p, normal)
            mask = mask & inside & (residual < angle_tol) & (prev_side * next_side > 0.0)
        else:
            e = edges[idx]
            ev = e[:, 1, :] - e[:, 0, :]
            t = safe_divide(_dot(p - e[:, 0, :], ev), _dot(ev, ev))
            margin = 1e-4
            on_segment = (t > margin) & (t < 1.0 - margin)
            # The Keller cone: equal angles with the edge on both sides.
            e_hat = normalize(ev)[0]
            keller = torch.abs(_dot(k_in, e_hat) - _dot(k_out, e_hat)) < angle_tol
            mask = mask & on_segment & keller
        # A degenerate candidate: consecutive same-kind slots, one index.
        if b > 0 and is_reflection[b] == is_reflection[b - 1]:
            mask = mask & (candidates[:, b] != candidates[:, b - 1])
    return mask


def _blocked_paths(mesh, full_paths, mask, candidates, types, *, hit_tol: float | None, min_len: float | None) -> TracedPaths:
    """The paths, their mask AND-ed with unblocked, long enough and finite."""
    if min_len is None:
        min_len = 10.0 * F32_EPS
    shape = full_paths.shape[:-2]
    order = candidates.shape[1]
    device = full_paths.device
    ray_origins = full_paths[..., :-1, :]
    segments = full_paths[..., 1:, :] - full_paths[..., :-1, :]
    blocked = mesh.ray_intersect_any_triangle(ray_origins, segments, hit_tol=hit_tol).any(dim=-1)
    too_small = ((segments * segments).sum(dim=-1) < min_len).any(dim=-1)
    is_finite = torch.isfinite(full_paths).all(dim=-1).all(dim=-1)
    full_paths = torch.where(is_finite[..., None, None], full_paths, 0.0)
    mask = mask & ~blocked & ~too_small & is_finite

    objects = torch.cat(
        (
            torch.arange(shape[0], dtype=torch.int32, device=device)[:, None, None, None].expand(*shape, 1),
            candidates.to(torch.int32).expand(*shape, order),
            torch.arange(shape[1], dtype=torch.int32, device=device)[None, :, None, None].expand(*shape, 1),
        ),
        dim=-1,
    )
    interaction_types = torch.tensor(types, dtype=torch.int32, device=device).expand(*shape, order)
    return TracedPaths(full_paths, objects, mask=mask, interaction_types=interaction_types)


def mixed_amplitudes(
    paths: TracedPaths,
    scene,
    frequency,
    *,
    edges: torch.Tensor,
    adjacent_triangles: torch.Tensor,
    wedge_n: torch.Tensor,
    eta_r,
    conductivity,
    thickness=None,
    types: Sequence[InteractionType | int] | None = None,
) -> torch.Tensor:
    """Complex channel amplitude of mixed reflection/diffraction paths (V polarization), ``[*batch]``.

    The (theta, phi) field components go through the chain: slab-aware
    Fresnel blocks at reflections, UTD ``diag(D_s, D_h)`` blocks (Luebbers
    lossy wedges) at diffractions. The spreading follows the astigmatic
    two radii: exact for paths with at most one diffraction, the usual
    cascade approximation beyond. ``edges``, ``adjacent_triangles`` and
    ``wedge_n`` are ``Mesh._diffraction_edges_info()`` of the (deduplicated)
    scene mesh; ``eta_r``, ``conductivity`` and ``thickness`` are per
    material.

    One signature per call, as :class:`MixedPathTracer` makes them: it is
    read on the host from ``paths.interaction_types``, or given as
    ``types`` (one :class:`~differt_tpu_torch.em.InteractionType` per
    interaction).
    """
    order = paths.order
    if types is None:
        types = tuple(int(t) for t in paths.interaction_types.reshape(-1, order)[0].tolist())
    else:
        types = tuple(int(t) for t in types)
        if len(types) != order:
            msg = f"`types` has {len(types)} entries but paths.order is {order}."
            raise ValueError(msg)
    return _mixed_amplitudes(
        paths,
        scene,
        frequency,
        edges=edges,
        adjacent_triangles=adjacent_triangles,
        wedge_n=wedge_n,
        eta_r=eta_r,
        conductivity=conductivity,
        thickness=thickness,
        types=types,
    )


def _mixed_amplitudes(
    paths: TracedPaths,
    scene,
    frequency,
    *,
    edges: torch.Tensor,
    adjacent_triangles: torch.Tensor,
    wedge_n: torch.Tensor,
    eta_r,
    conductivity,
    thickness,
    types: tuple[int, ...],
) -> torch.Tensor:
    """:func:`mixed_amplitudes` for a known signature.

    The per-triangle and per-edge quantities form two tables, gathered per
    path with :func:`~differt_tpu_torch.utils.gather_columns`; the vector
    algebra runs on component tuples of batch-shaped tensors.
    """
    from ..em._constants import c, epsilon_0
    from ..em._fresnel import reflection_coefficients, slab_reflection_coefficients
    from ..em._utd import diffraction_coefficients
    from ..utils import (
        cross3,
        dot3,
        gather_columns,
        normalize3,
        sp_directions3,
        spherical3,
        unpack_vertices3,
    )

    device = paths.vertices.device
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=device)
    # True divisions, as in diffraction_amplitudes: `scalar / tensor` is a
    # reciprocal and a product, an ulp off, and k times a path of tens of
    # metres turns an ulp of k into 2e-4 of the phase.
    wavelength = frequency.new_tensor(c) / frequency
    k_wave = frequency.new_tensor(2.0 * math.pi) / wavelength
    eta_r = torch.as_tensor(eta_r, dtype=torch.float32, device=device)
    conductivity = torch.as_tensor(conductivity, dtype=torch.float32, device=device)
    thickness = (
        torch.full_like(eta_r, -1.0)
        if thickness is None
        else torch.as_tensor(thickness, dtype=torch.float32, device=device)
    )
    omega = 2.0 * math.pi * frequency
    n_complex = torch.sqrt(eta_r - 1j * conductivity / (omega * epsilon_0))

    mesh = scene.mesh
    normals_t = mesh.normals
    num_tri = normals_t.shape[0]
    if mesh.face_materials is None:
        mats = torch.zeros(num_tri, dtype=torch.int64, device=device)
    else:
        # Clamped, as in coverage.complex_amplitudes.
        mats = mesh.face_materials.clamp(0, n_complex.shape[0] - 1)

    # The per-triangle table of the reflections.
    n_r_tri = n_complex[mats]
    tri_table = torch.cat(
        (normals_t.to(torch.float32), n_r_tri.real[:, None], n_r_tri.imag[:, None], thickness[mats][:, None]), dim=-1
    )
    # The per-edge table of the diffractions: the edge's direction oriented
    # so that (t_o, n_o, e_hat) is right-handed, the o-face's tangent and
    # normal, n, and both faces' refractive indices.
    edge_origin_t = edges[:, 0, :]
    e_hat_t = normalize(edges[:, 1, :] - edge_origin_t)[0]
    o_face = adjacent_triangles[:, 0].clamp(min=0)
    n_face = adjacent_triangles[:, 1].clamp(min=0)
    n_o_t = normals_t[o_face]
    t_o_t = _face_tangent(mesh.triangle_vertices.mean(dim=-2)[o_face], edge_origin_t, e_hat_t)
    flip = _dot(_cross(t_o_t, n_o_t), e_hat_t) < 0.0
    e_hat_t = torch.where(flip[:, None], -e_hat_t, e_hat_t)
    n_r_o_t, n_r_n_t = n_r_tri[o_face], n_r_tri[n_face]
    edge_table = torch.cat(
        [
            col.to(torch.float32)
            for col in (
                e_hat_t,
                t_o_t,
                n_o_t,
                wedge_n[:, None],
                n_r_o_t.real[:, None],
                n_r_o_t.imag[:, None],
                n_r_n_t.real[:, None],
                n_r_n_t.imag[:, None],
            )
        ],
        dim=-1,
    )

    pts = unpack_vertices3(paths.vertices, paths.valid_mask)
    k_hats, lengths = [], []
    for i in range(len(pts) - 1):
        k_hat, s_len = normalize3(tuple(pts[i + 1][a] - pts[i][a] for a in range(3)))
        k_hats.append(k_hat)
        lengths.append(s_len)
    frames = [spherical3(k) for k in k_hats]

    batch = paths.mask.shape
    e_theta = torch.ones(batch, dtype=torch.complex64, device=device)
    e_phi = torch.zeros(batch, dtype=torch.complex64, device=device)
    # The astigmatic wavefront radii at the current interaction point; both
    # are the distance travelled for the spherical wave off the TX.
    r1 = r2 = lengths[0]
    spread = torch.ones_like(lengths[0])

    for b, kind in enumerate(types):
        obj = paths.objects[..., b + 1]
        k_in, k_out = k_hats[b], k_hats[b + 1]
        s_next = lengths[b + 1]
        (th_in, ph_in), (th_out, ph_out) = frames[b], frames[b + 1]

        if kind == _REFLECTION:
            cols = gather_columns(tri_table, obj)
            normal = (cols[0], cols[1], cols[2])
            cos_theta_i = dot3(normal, tuple(-comp for comp in k_in))
            r_s, r_p = slab_reflection_coefficients(torch.complex(cols[3], cols[4]), cos_theta_i, cols[5], wavelength)
            (e_i_s, e_i_p), (e_r_s, e_r_p) = sp_directions3(k_in, k_out, normal)
            f_s = r_s * (dot3(e_i_s, th_in) * e_theta + dot3(e_i_s, ph_in) * e_phi)
            f_p = r_p * (dot3(e_i_p, th_in) * e_theta + dot3(e_i_p, ph_in) * e_phi)
            e_theta = dot3(th_out, e_r_s) * f_s + dot3(th_out, e_r_p) * f_p
            e_phi = dot3(ph_out, e_r_s) * f_s + dot3(ph_out, e_r_p) * f_p
            # A planar mirror: both radii continue.
            spread = spread * torch.sqrt(safe_divide(r1 * r2, (r1 + s_next) * (r2 + s_next)))
            r1 = r1 + s_next
            r2 = r2 + s_next
        else:
            cols = gather_columns(edge_table, obj)
            e_hat = (cols[0], cols[1], cols[2])
            t_o = (cols[3], cols[4], cols[5])
            n_o = (cols[6], cols[7], cols[8])
            n_param = cols[9]

            cos_beta = dot3(k_in, e_hat)
            sin_beta_0 = torch.sqrt(torch.clamp(1.0 - cos_beta * cos_beta, 1e-12, 1.0))

            def azimuth(v, e_hat=e_hat, t_o=t_o, n_o=n_o):
                par = dot3(v, e_hat)
                perp = normalize3(tuple(v[a] - par * e_hat[a] for a in range(3)))[0]
                ang = torch.atan2(dot3(perp, n_o), dot3(perp, t_o))
                return torch.where(ang < 0.0, ang + 2.0 * math.pi, ang)

            phi_i = azimuth(tuple(-comp for comp in k_in))
            phi_d = azimuth(k_out)
            # The astigmatic distance parameter (McNamara 6.25), the edge
            # caustic's radius taken as the continued radius r2.
            length = safe_divide(
                s_next * (r2 + s_next) * r1 * r2 * sin_beta_0 * sin_beta_0,
                r2 * (r1 + s_next) * (r2 + s_next),
            )
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
            # The edge-fixed frames.
            phi_i_hat = normalize3(cross3(e_hat, k_in))[0]
            beta_i_hat = normalize3(cross3(phi_i_hat, k_in))[0]
            phi_d_hat = normalize3(cross3(e_hat, k_out))[0]
            beta_d_hat = normalize3(cross3(phi_d_hat, k_out))[0]
            f_beta = d_s * (dot3(beta_i_hat, th_in) * e_theta + dot3(beta_i_hat, ph_in) * e_phi)
            f_phi = d_h * (dot3(phi_i_hat, th_in) * e_theta + dot3(phi_i_hat, ph_in) * e_phi)
            e_theta = dot3(th_out, beta_d_hat) * f_beta + dot3(th_out, phi_d_hat) * f_phi
            e_phi = dot3(ph_out, beta_d_hat) * f_beta + dot3(ph_out, phi_d_hat) * f_phi
            # The edge caustic: the first radius restarts at the edge.
            rho = r2
            spread = spread * torch.sqrt(safe_divide(rho, s_next * (rho + s_next)))
            r1 = s_next
            r2 = rho + s_next

    # Onto the receiver's V polarization.
    k_last = k_hats[-1]
    theta_out, _ = spherical3(k_last)
    theta_neg, _ = spherical3(tuple(-comp for comp in k_last))
    a = dot3(theta_out, theta_neg) * e_theta

    s_tot = lengths[0]
    for s_len in lengths[1:]:
        s_tot = s_tot + s_len
    a = a * spread * safe_divide(torch.ones_like(lengths[0]), lengths[0])
    phase = -k_wave * s_tot
    a = a * torch.complex(torch.cos(phase), torch.sin(phase))
    a = a * (wavelength / (4.0 * math.pi))
    return a * paths.mask.to(torch.float32)
