"""General-purpose tensor utilities (PyTorch port of ``differt_tpu.utils``).

The structure-of-arrays helpers carry every 3-vector as an ``(x, y, z)``
tuple of batch-shaped tensors, like the JAX package's EM pipeline, so the
port's arithmetic runs in the same order as the reference's.
"""

import torch


def sample_points_in_bounding_box(
    bounding_box: torch.Tensor,
    shape: tuple[int, ...] = (),
    *,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """``[*shape, 3]`` points drawn uniformly inside a ``[2, 3]`` (min, max) box, on the box's device.

    The draws come from ``generator`` (on its own device; the default
    generator of the box's device when None).

    >>> box = torch.tensor([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]])
    >>> p = sample_points_in_bounding_box(box, (100,), generator=torch.Generator().manual_seed(0))
    >>> p.shape, bool(((p >= box[0]) & (p <= box[1])).all())
    (torch.Size([100, 3]), True)
    """
    bounding_box = torch.as_tensor(bounding_box)
    lo, hi = bounding_box[0], bounding_box[1]
    device = bounding_box.device if generator is None else generator.device
    u = torch.rand((*shape, 3), generator=generator, dtype=lo.dtype, device=device).to(lo.device)
    return lo + u * (hi - lo)


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


def smoothing_function(x: torch.Tensor, smoothing_factor=1.0) -> torch.Tensor:
    """Smooth approximation of the Heaviside step: ``sigmoid(x * smoothing_factor)``.

    The relaxation that turns a hard validity test into a confidence in
    [0, 1] through which gradients flow.

    >>> import torch
    >>> float(smoothing_function(torch.tensor(0.0)))
    0.5
    >>> bool(smoothing_function(torch.tensor(4.0), 10.0) > 0.99)
    True
    """
    return torch.sigmoid(torch.as_tensor(x) * smoothing_factor)


def min_with_initial(x: torch.Tensor, dim: int, initial: float = 1.0) -> torch.Tensor:
    """``jnp.min(x, axis=dim, initial=initial)``, with JAX's gradient at ties.

    ``amin`` splits the gradient evenly among equal minima, as
    ``jnp.min`` does (``torch.min(dim=...)`` would send it to one index),
    and ``torch.minimum`` halves it on a tie with ``initial``, as
    ``lax.min`` does. An empty axis (order 0) gives ``initial``.
    """
    if x.shape[dim] == 0:
        shape = list(x.shape)
        del shape[dim]
        return x.new_full(shape, initial)
    return torch.minimum(x.amin(dim=dim), x.new_tensor(initial))


def max_with_initial(x: torch.Tensor, dim: int, initial: float = 0.0) -> torch.Tensor:
    """``jnp.max(x, axis=dim, initial=initial)``; see :func:`min_with_initial`."""
    if x.shape[dim] == 0:
        shape = list(x.shape)
        del shape[dim]
        return x.new_full(shape, initial)
    return torch.maximum(x.amax(dim=dim), x.new_tensor(initial))


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
    """Zero-safe normalize of a component tuple; returns ``(unit, length)``.

    The square root sees 1 where the vector is zero (``sq + zero`` adds the
    bool), so that its backward is finite there and not ``0 * inf``: a zero
    cross product (a ray along a face's normal) would otherwise send NaN
    to the mesh's vertices. Same values, and as many kernels, as
    ``a / where(n == 0, 1, n)``.
    """
    sq = dot3(a, a)
    zero = sq == 0.0
    n = torch.sqrt(sq + zero)
    return tuple(comp / n for comp in a), torch.where(zero, sq, n)


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


def unpack_vertices3(vertices: torch.Tensor, valid: torch.Tensor) -> list[list[torch.Tensor]]:
    """Unpack ``[*batch, L, 3]`` path vertices into ``L`` component tuples of ``[*batch]`` tensors.

    Invalid paths (``valid`` False) are replaced by a straight dummy path
    (point ``l`` at ``x = l``), so that normalizations and their gradients
    stay finite; callers weight them by 0.

    >>> import torch
    >>> pts = unpack_vertices3(torch.ones((2, 3, 3)), torch.tensor([True, False]))
    >>> [p[0].tolist() for p in pts]
    [[1.0, 0.0], [1.0, 1.0], [1.0, 2.0]]
    """
    v_soa = torch.movedim(vertices, (-2, -1), (0, 1))
    return [
        [
            torch.where(valid, v_soa[l, axis], float(l) if axis == 0 else 0.0)
            for axis in range(3)
        ]
        for l in range(vertices.shape[-2])
    ]


def gather_columns(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row-gather from a ``[T, C]`` table, returned as ``[C, *idx.shape]``.

    A plain gather: the JAX package's one-hot matmul form exists only for
    the TPU's matrix unit. It is written as an embedding lookup, whose
    values are those of ``table[idx]`` and whose backward sorts the indices
    and reduces each row's run: a coverage tile repeats each of its few
    hundred candidate rows tens of thousands of times, and the backward of
    ``table[idx]`` adds those up one by one.
    """
    return torch.movedim(torch.nn.functional.embedding(idx, table), -1, 0)
