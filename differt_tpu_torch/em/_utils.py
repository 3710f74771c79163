"""Delays, polarization frames, Jones transition matrices and path loss (port of ``differt_tpu.em._utils``).

Vectors are ``[*batch, 3]`` tensors, as in the JAX package. The frames are
built by the structure-of-arrays helpers of :mod:`..utils`
(:func:`~..utils.normalize3`, :func:`~..utils.sp_directions3`,
:func:`~..utils.spherical3`), which the coverage path uses too: the square
root of :func:`~..utils.normalize3` sees 1 at zero length, so that its
backward stays finite there (the JAX package's ``normalize`` is NaN).
"""

import math

import torch

from ..geometry._vectors import path_length
from ..utils import normalize3, sp_directions3, spherical3
from ._constants import c
from ._fresnel import slab_reflection_coefficients


def _components(*vectors: torch.Tensor) -> list[tuple[torch.Tensor, ...]]:
    """Broadcast ``[*batch, 3]`` tensors together and split each into its three components."""
    return [tuple(v.unbind(-1)) for v in torch.broadcast_tensors(*vectors)]


def _stack(comps) -> torch.Tensor:
    return torch.stack(comps, dim=-1)


def length_to_delay(length, speed=c) -> torch.Tensor:
    """Propagation delay (s) over ``length`` (m).

    >>> round(float(length_to_delay(299792458.0)), 6)
    1.0
    """
    return torch.as_tensor(length) / torch.as_tensor(speed)


def path_delay(path: torch.Tensor, **kwargs) -> torch.Tensor:
    """Propagation delay (s) of each ``[*batch, path_length, 3]`` polyline path."""
    return length_to_delay(path_length(path), **kwargs)


def sp_directions(
    k_i: torch.Tensor, k_r: torch.Tensor, normals: torch.Tensor
) -> tuple[tuple[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]:
    """Local ``((e_i_s, e_i_p), (e_r_s, e_r_p))`` polarization frames of a reflection.

    At normal incidence the plane of incidence is undefined and ``s`` is a
    fixed perpendicular of ``k_i`` (the JAX package's branch rule).
    """
    k_i, k_r, normals = _components(k_i, k_r, normals)
    (e_i_s, e_i_p), (e_r_s, e_r_p) = sp_directions3(k_i, k_r, normals)
    return (_stack(e_i_s), _stack(e_i_p)), (_stack(e_r_s), _stack(e_r_p))


def sp_rotation_matrix(
    e_a_s: torch.Tensor, e_a_p: torch.Tensor, e_b_s: torch.Tensor, e_b_p: torch.Tensor
) -> torch.Tensor:
    """``[*batch, 2, 2]`` matrix taking (s, p) components in basis ``a`` to basis ``b``."""
    basis_a = torch.stack(torch.broadcast_tensors(e_a_s, e_a_p), dim=-2)
    basis_b = torch.stack(torch.broadcast_tensors(e_b_s, e_b_p), dim=-2)
    basis_a, basis_b = torch.broadcast_tensors(basis_a, basis_b)
    return torch.einsum("...ik,...jk->...ij", basis_b, basis_a)


def spherical_basis(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Spherical unit vectors ``(theta_hat, phi_hat)`` of unit directions ``k``.

    Built without angles, so gradients stay finite; at the poles the
    ``phi = 0`` convention is pinned (``theta_hat = (z, 0, 0)``,
    ``phi_hat = (0, 1, 0)``).

    >>> import torch
    >>> theta_hat, phi_hat = spherical_basis(torch.tensor([0.0, 0.0, 1.0]))
    >>> theta_hat.tolist(), phi_hat.tolist()
    ([1.0, 0.0, -0.0], [-0.0, 1.0, 0.0])
    """
    theta_hat, phi_hat = spherical3(tuple(k.unbind(-1)))
    return _stack(theta_hat), _stack(phi_hat)


def _frames(vertices, object_normals, n_r, thickness, wavelength):
    """Per-segment spherical frames and per-bounce (s, p) frames and coefficients."""
    segments = vertices[..., 1:, :] - vertices[..., :-1, :]
    k = _stack(normalize3(tuple(segments.unbind(-1)))[0])
    theta_hat, phi_hat = spherical_basis(k)
    k_in, k_out = k[..., :-1, :], k[..., 1:, :]
    (e_i_s, e_i_p), (e_r_s, e_r_p) = sp_directions(k_in, k_out, object_normals)
    cos_theta_i = (object_normals * -k_in).sum(dim=-1)
    r_s, r_p = slab_reflection_coefficients(
        torch.as_tensor(n_r), cos_theta_i, torch.as_tensor(thickness), wavelength
    )
    return theta_hat, phi_hat, (e_i_s, e_i_p, e_r_s, e_r_p), (r_s, r_p)


def transition_apply(
    vertices: torch.Tensor,
    object_normals: torch.Tensor,
    n_r: torch.Tensor,
    thickness: torch.Tensor,
    wavelength,
    e_theta: torch.Tensor,
    e_phi: torch.Tensor,
    interaction_types: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Carry a field's ``(e_theta, e_phi)`` through a path's bounces, component by component.

    ``vertices [*batch, L, 3]`` (TX, bounces, RX), ``object_normals [*batch,
    L - 2, 3]``, complex ``n_r`` and ``thickness`` ``[*batch, L - 2]``
    (negative: semi-infinite). The physics of :func:`transition_matrix`;
    only reflections (type 0) act, other types pass the field on.
    """
    e_theta = torch.as_tensor(e_theta)
    e_phi = torch.as_tensor(e_phi)
    order = vertices.shape[-2] - 2
    if order == 0:
        return e_theta, e_phi
    theta_hat, phi_hat, (e_i_s, e_i_p, e_r_s, e_r_p), (r_s, r_p) = _frames(
        vertices, object_normals, n_r, thickness, wavelength
    )
    is_reflection = None if interaction_types is None else interaction_types == 0

    def dot(a, b):
        return (a * b).sum(dim=-1)

    for b in range(order):
        th_in, ph_in = theta_hat[..., b, :], phi_hat[..., b, :]
        th_out, ph_out = theta_hat[..., b + 1, :], phi_hat[..., b + 1, :]
        # (theta, phi) -> local (s, p), scaled by the coefficients.
        f_s = r_s[..., b] * (dot(e_i_s[..., b, :], th_in) * e_theta + dot(e_i_s[..., b, :], ph_in) * e_phi)
        f_p = r_p[..., b] * (dot(e_i_p[..., b, :], th_in) * e_theta + dot(e_i_p[..., b, :], ph_in) * e_phi)
        # Local (s, p) -> the next segment's (theta, phi).
        new_theta = dot(th_out, e_r_s[..., b, :]) * f_s + dot(th_out, e_r_p[..., b, :]) * f_p
        new_phi = dot(ph_out, e_r_s[..., b, :]) * f_s + dot(ph_out, e_r_p[..., b, :]) * f_p
        if is_reflection is not None:
            keep = is_reflection[..., b]
            new_theta = torch.where(keep, new_theta, e_theta)
            new_phi = torch.where(keep, new_phi, e_phi)
        e_theta, e_phi = new_theta, new_phi
    return e_theta, e_phi


def transition_matrix(
    vertices: torch.Tensor,
    object_normals: torch.Tensor,
    n_r: torch.Tensor,
    thickness: torch.Tensor,
    wavelength,
    interaction_types: torch.Tensor | None = None,
) -> torch.Tensor:
    """The chained ``[*batch, 2, 2]`` complex Jones matrix of a multi-bounce path.

    In the spherical ``(theta, phi)`` frames of the first and last
    segments: each bounce rotates the field into its local (s, p) frame,
    scales it by ``diag(r_s, r_p)`` (slab-aware Fresnel) and rotates it
    into the next segment's frame. Inputs as in :func:`transition_apply`;
    bounces of another type than reflection are the identity.
    """
    order = vertices.shape[-2] - 2
    batch = torch.broadcast_shapes(
        vertices.shape[:-2], object_normals.shape[:-2], torch.as_tensor(n_r).shape[:-1]
    )
    cdtype = torch.complex128 if vertices.dtype == torch.float64 else torch.complex64
    eye = torch.eye(2, dtype=cdtype, device=vertices.device).expand(*batch, 2, 2)
    if order == 0:
        return eye
    theta_hat, phi_hat, (e_i_s, e_i_p, e_r_s, e_r_p), (r_s, r_p) = _frames(
        vertices, object_normals, n_r, thickness, wavelength
    )
    in_rot = sp_rotation_matrix(theta_hat[..., :-1, :], phi_hat[..., :-1, :], e_i_s, e_i_p)
    out_rot = sp_rotation_matrix(e_r_s, e_r_p, theta_hat[..., 1:, :], phi_hat[..., 1:, :])
    zero = torch.zeros_like(r_s)
    d = torch.stack((torch.stack((r_s, zero), dim=-1), torch.stack((zero, r_p), dim=-1)), dim=-2)
    j_mat = out_rot.to(cdtype) @ (d.to(cdtype) @ in_rot.to(cdtype))
    if interaction_types is not None:
        is_reflection = (interaction_types == 0)[..., None, None]
        j_mat = torch.where(is_reflection, j_mat, torch.eye(2, dtype=cdtype, device=j_mat.device))
    total = eye
    for idx in range(order):
        total = j_mat[..., idx, :, :] @ total
    return total


def fspl(d, f, *, dB: bool = False) -> torch.Tensor:  # noqa: N803
    """Free-space path loss at distance ``d`` (m) and frequency ``f`` (Hz), linear or in dB.

    >>> round(float(fspl(1000.0, 2.4e9, dB=True)), 2)  # 1 km at 2.4 GHz
    100.05
    """
    d = torch.as_tensor(d)
    f = torch.as_tensor(f)
    if dB:
        return 20 * torch.log10(d) + 20 * torch.log10(f) - 147.55221677811662
    x = 4 * math.pi * d * f / c
    return x * x
