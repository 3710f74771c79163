"""Ray-launching lattice and viewing frustum (PyTorch port of ``differt_tpu.geometry._lattice``)."""

import functools
import math

import torch

from ._vectors import cartesian_to_spherical, spherical_to_cartesian

_INV_PHI = 2.0 / (1.0 + math.sqrt(5.0))  # golden-ratio conjugate, 1/phi

# (i / phi) mod 1 in float32 loses the azimuths of a large lattice: at
# i ~ 10^7 the product carries ~6 fractional bits. The Fibonacci ladder of
# the JAX package restores them: F_m / phi = F_{m-1} - (-1/phi)^m, so
# taking q * F_m off the index shifts frac(i / phi) by the exactly known,
# tiny defect q * (-(-1/phi)^m), and the residual index (< 13) times 1/phi
# is exact in float32.
_FIB_LADDER: tuple[tuple[float, float], ...] = tuple(
    (float(fib), -((-_INV_PHI) ** m))
    for fib, m in ((832040, 30), (10946, 21), (144, 12), (13, 7))
)


def _golden_fractions(i: torch.Tensor) -> torch.Tensor:
    """Fractional part of ``i / phi``, accurate in float32 up to ``i < 2**24``."""
    frac = torch.zeros_like(i)
    for fib, defect in _FIB_LADDER:
        q = torch.floor(i / fib)
        i = i - q * fib
        frac = frac + q * defect
    return (frac + i * _INV_PHI) % 1.0


def _lattice_fractions(n: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(i, step, frac)`` of each index of an ``n``-point lattice, float32.

    ``step = i / (n - 1)`` places the point in a frustum's cos(polar) span,
    ``frac``, the golden fraction of ``i``, in its azimuth span.
    """
    i = torch.arange(n, dtype=torch.float32, device=device)
    step = i / (n - 1) if n > 1 else i
    return i, step, _golden_fractions(i)


def fibonacci_lattice(
    n: int,
    dtype: torch.dtype | None = None,
    *,
    frustum: torch.Tensor | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Quasi-uniform lattice of ``n`` unit vectors on the sphere, ``[n, 3]``.

    With ``frustum`` (min and max rows of ``(polar, azimuth)``; a leading
    radial column is ignored), the points are spread uniformly in solid
    angle within it, on the frustum's device and dtype; otherwise on
    ``device``, the card when None. A batch of frustums ``[*batch, 2, 3]``
    gives ``[*batch, n, 3]``, each row as its frustum alone would give it.

    >>> pts = fibonacci_lattice(100, device="cpu")
    >>> tuple(pts.shape), bool(((pts * pts).sum(-1) - 1.0).abs().max() < 1e-6)
    ((100, 3), True)
    """
    if n <= 0:
        msg = f"fibonacci_lattice needs a strictly positive size, got n={n}."
        raise ValueError(msg)
    if frustum is not None:
        dtype = frustum.dtype
        device = frustum.device
    elif dtype is not None and not dtype.is_floating_point:
        msg = f"fibonacci_lattice needs a floating dtype, got {dtype!r}."
        raise ValueError(msg)
    elif device is None:
        device = torch.device("cuda")

    i, step, frac = _lattice_fractions(n, device)

    if frustum is not None:
        # Uniform steps in cos(polar) are equal steps of solid angle; the
        # golden fractions spread the azimuths over the frustum's span.
        polar_lo, polar_hi = frustum[..., 0, -2, None], frustum[..., 1, -2, None]
        azim_lo, azim_hi = frustum[..., 0, -1, None], frustum[..., 1, -1, None]
        cos_polar = torch.cos(polar_lo) * (1.0 - step) + torch.cos(polar_hi) * step
        polar = torch.arccos(cos_polar)
        azimuth = azim_lo * (1.0 - frac) + azim_hi * frac
    else:
        polar = torch.arccos(1.0 - 2.0 * i / n)
        azimuth = 2.0 * math.pi * frac

    xyz = spherical_to_cartesian(torch.stack((polar, azimuth), dim=-1))
    return xyz.to(dtype) if dtype is not None else xyz


@functools.lru_cache(maxsize=8)
def lattice_slots(n: int, device: torch.device) -> torch.Tensor:
    """``[n, 4]`` float32: ``(step, 1 - step, frac, 1 - frac)`` of each point of an ``n``-point lattice, in slot order.

    The frustum-free terms of :func:`fibonacci_lattice`, computed by its own
    operations on ``device`` (so bit-equal to the lattice's), for a kernel that makes
    each vertex's lattice rays itself (``frustum_terms`` give the rest).
    Slot order sorts the indices by band, a run of ``isqrt(32 pi n)``
    consecutive indices, then by ``frac``: where 32 consecutive indices lie
    on one thin ring at azimuths spread over the whole span, 32 consecutive
    slots make a compact patch. A band spans ``2 w / n`` of cos(polar) and
    32 slots ``2 pi 32 / w`` of azimuth, so on a frustum of the whole
    circle and the whole of cos(polar) (a street vertex's) the patch is
    square at ``w**2 = 32 pi n``. Of ``w**2`` from ``8 n`` to ``256 pi n``,
    visibility on an H100 ran fastest there (0.8% faster than at ``32 n``,
    where the patch is square in lattice steps). Built once per ``(n, device)``.

    >>> slots = lattice_slots(5, torch.device("cpu"))
    >>> tuple(slots.shape), sorted(slots[:, 0].mul(4).round().int().tolist())
    ((5, 4), [0, 1, 2, 3, 4])
    """
    if n <= 0:
        msg = f"lattice_slots needs a strictly positive size, got n={n}."
        raise ValueError(msg)
    _, step, frac = _lattice_fractions(n, device)
    width = math.isqrt(int(32 * math.pi * n))
    order = torch.argsort(frac, stable=True)
    order = order[torch.argsort(order // width, stable=True)]
    return torch.stack((step, 1.0 - step, frac, 1.0 - frac), dim=-1)[order].contiguous()


def frustum_terms(frustum: torch.Tensor) -> torch.Tensor:
    """``[*batch, 4]``: ``(cos(polar_lo), cos(polar_hi), azim_lo, azim_hi)`` of ``[*batch, 2, 3]`` frustums, as :func:`fibonacci_lattice` takes them."""
    polar, azimuth = frustum[..., -2], frustum[..., -1]
    return torch.stack(
        (torch.cos(polar[..., 0]), torch.cos(polar[..., 1]), azimuth[..., 0], azimuth[..., 1]), dim=-1
    )


def _masked_min(x, mask, initial: float, dims):
    # jnp.min(x, where=mask, initial=initial): the initial value takes part.
    if mask is not None:
        x = torch.where(mask, x, initial)
    return x.amin(dim=dims).clamp(max=initial)


def _masked_max(x, mask, initial: float, dims):
    if mask is not None:
        x = torch.where(mask, x, initial)
    return x.amax(dim=dims).clamp(min=initial)


def viewing_frustum(
    viewing_vertex: torch.Tensor,
    world_vertices: torch.Tensor,
    *,
    active_vertices: torch.Tensor | None = None,
    reduce: bool = False,
) -> torch.Tensor:
    """Spherical bounding frustum of ``world_vertices`` seen from ``viewing_vertex``.

    ``viewing_vertex`` is ``[*batch, 3]``, ``world_vertices`` ``[*batch,
    num_vertices, 3]`` (broadcasting). Returns ``[*batch, 2, 3]``: min and
    max rows of ``(r, polar, azimuth)`` (``[2, 3]`` over everything with
    ``reduce``). The azimuth bounds are taken in ``[-pi, pi)`` and in
    ``[0, 2 pi)`` and the narrower span wins; above 270 degrees in both,
    the full circle. A degenerate polar band is widened toward the pole
    that gives the smaller span.
    """
    rpa = cartesian_to_spherical(world_vertices - viewing_vertex[..., None, :])
    r, p, a = rpa[..., 0], rpa[..., 1], rpa[..., 2]
    mask = active_vertices
    dims = tuple(range(r.ndim)) if reduce else -1
    pi, two_pi = math.pi, 2.0 * math.pi

    r_min = _masked_min(r, mask, math.inf, dims)
    r_max = _masked_max(r, mask, 0.0, dims)
    p_min = _masked_min(p, mask, pi, dims)
    p_max = _masked_max(p, mask, 0.0, dims)

    a_min = _masked_min(a, mask, pi, dims)
    a_max = _masked_max(a, mask, -pi, dims)
    a_shifted = (a + two_pi) % two_pi
    a0_min = _masked_min(a_shifted, mask, two_pi, dims)
    a0_max = _masked_max(a_shifted, mask, 0.0, dims)

    width = a_max - a_min
    width0 = a0_max - a0_min
    use_shifted = width > width0
    a_min = torch.where(use_shifted, a0_min, a_min)
    a_max = torch.where(use_shifted, a0_max, a_max)
    # Geometry all around the viewer: the full circle.
    full_circle = torch.minimum(width, width0) > 1.5 * pi
    a_min = torch.where(full_circle, -pi, a_min)
    a_max = torch.where(full_circle, pi, a_max)

    p_min_dn = torch.where(p_min == p_max, 0.0, p_min)
    p_max_up = torch.where(p_min == p_max, pi, p_max)
    widen_up = (p_max - p_min_dn) > (p_max_up - p_min)
    p_lo = torch.where(widen_up, p_min, p_min_dn)
    p_hi = torch.where(widen_up, p_max_up, p_max)

    out = torch.stack((r_min, p_lo, a_min, r_max, p_hi, a_max), dim=-1)
    return out.reshape(*out.shape[:-1], 2, 3)
