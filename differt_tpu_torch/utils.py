"""General-purpose tensor utilities (PyTorch port of ``differt_tpu.utils``).

The structure-of-arrays helpers carry every 3-vector as an ``(x, y, z)``
tuple of batch-shaped tensors, like the JAX package's EM pipeline, so the
port's arithmetic runs in the same order as the reference's.
"""

import torch


def safe_divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """Elementwise division that returns 0 where the denominator is 0.

    >>> import torch
    >>> safe_divide(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([2.0, 0.0, 1.0])).tolist()
    [0.5, 0.0, 3.0]
    """
    num = torch.as_tensor(num)
    den = torch.as_tensor(den)
    zero = den == 0
    out = num / torch.where(zero, torch.ones_like(den), den)
    return torch.where(zero, torch.zeros_like(out), out)


def dot3(a, b):
    """Dot product of component-tuple 3-vectors."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    """Cross product of component-tuple 3-vectors."""
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def normalize3(a):
    """Zero-safe normalize of a component tuple; returns ``(unit, length)``."""
    n = torch.sqrt(dot3(a, a))
    safe = torch.where(n == 0.0, torch.ones_like(n), n)
    return tuple(comp / safe for comp in a), n


def spherical3(k):
    """Spherical unit vectors ``(theta_hat, phi_hat)`` of direction ``k``."""
    x, y, z = k
    s_sq = x * x + y * y
    degenerate = s_sq < 1e-12
    one = torch.ones_like(s_sq)
    zero = torch.zeros_like(s_sq)
    s = torch.sqrt(torch.where(degenerate, one, s_sq))
    cos_p = torch.where(degenerate, one, x / s)
    sin_p = torch.where(degenerate, zero, y / s)
    s_out = torch.where(degenerate, zero, s)
    theta_hat = (z * cos_p, z * sin_p, -s_out)
    phi_hat = (-sin_p, cos_p, zero)
    return theta_hat, phi_hat


def perpendicular3(u):
    """A unit vector perpendicular to ``u`` (same branch rule as the reference)."""
    ux, uy, uz = u
    zeros = torch.zeros_like(ux)
    pick_a = torch.abs(ux) > torch.abs(uy)
    cand = (
        torch.where(pick_a, -uy, zeros),
        torch.where(pick_a, ux, -uz),
        torch.where(pick_a, zeros, uy),
    )
    return normalize3(cross3(u, cand))[0]


def sp_directions3(k_i, k_r, normal):
    """Incident and reflected ``(s, p)`` directions, with a normal-incidence fallback."""
    e_i_s, norm = normalize3(cross3(k_i, normal))
    perp = perpendicular3(k_i)
    degenerate = norm == 0.0
    e_i_s = tuple(torch.where(degenerate, p, e) for p, e in zip(perp, e_i_s))
    e_i_p = normalize3(cross3(e_i_s, k_i))[0]
    e_r_p = normalize3(cross3(e_i_s, k_r))[0]
    return (e_i_s, e_i_p), (e_i_s, e_r_p)


def gather_columns(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-gather from a ``[T, C]`` table, returned as ``[C, *idx.shape]``.

    Plain indexing: the JAX package's one-hot matmul form exists only for
    the TPU's matrix unit.
    """
    return torch.movedim(table[idx], -1, 0)
