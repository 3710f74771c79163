"""Any-hit ray casting: the Hopper kernel's wrapper, its plain version and the BVH's helpers.

Replaces the TPU kernel ``differt_tpu/ops/_pallas_rt.py::_anyhit_kernel``
(driver ``_run_anyhit``, entry ``pallas_ray_intersect_any_triangle``) with
the hand-written CUDA kernel in ``differt_tpu_torch/csrc/anyhit.cu``.

The kernel walks the mesh's BVH (:mod:`._bvh`); the mesh (1 MB at 20,738
triangles) sits in L2, so memory traffic is not the limit, but the walk is a
chain of dependent fetches at L2 latency. With few live rays (the main
path's 128 order-0 segments; the unfused pipeline's million-ray chunks, of
which about one ray in 1,000 is live) one walk per ray would leave most of
the card's 132 SMs idle and last as long as the longest walk; with many, a
warp would wait for its slowest ray while finished rays idle its lanes. So
a first kernel lists the live rays, and the second splits each live ray's
walk into work items, one per subtree at the level :func:`anyhit_split`
picks from the live count (on the device, with no host sync); persistent
warps take the items from a queue, refilling each lane as its item ends
(see the kernel's header note).

The helpers the BVH is built from (Morton sort, boxes with a margin, the
fold of boxes, the slab test) are plain PyTorch here and keep the
reference's semantics, so that they can be compared with the JAX
package's.
"""

import torch

from ..rt._scan import any_hit_below
from ..rt._triangle import F32_EPS
from ._build import check_launch, load_kernels

T_SUB = 64
"""Triangles per chunk of the JAX kernels' culling (and of the closest-hit tie key)."""
_SLAB_TINY = 1e-30
_MAX_PAIRS = 1 << 24
"""Ray-triangle pairs per tile of the plain any-hit version (bounds its memory)."""
SPLIT_ITEMS = 1 << 17
"""Work items the any-hit kernel's split aims at: about one for each thread the card holds at once."""
_MAX_ITEMS = 1 << 30
"""Most work items one any-hit launch takes (its queue counts them in int32)."""

LAUNCHES = 0
"""Launches of the CUDA any-hit kernel in this process."""
REFERENCE_CALLS = 0
"""Calls of :func:`ray_intersect_any_triangle_reference` in this process."""


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    # uint32 shifts of the reference, in int64 masked to 32 bits.
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_perm_points(points: torch.Tensor) -> torch.Tensor:
    """Permutation sorting 3D points along a Morton (Z-order) curve.

    Equal to the JAX package's permutation (stable sort of the same codes).

    >>> import torch
    >>> pts = torch.tensor([[0.0, 0, 0], [9, 9, 9], [0.1, 0, 0], [9, 8.9, 9]])
    >>> morton_perm_points(pts).tolist()
    [0, 2, 3, 1]
    """
    if points.shape[0] == 0:
        return torch.empty(0, dtype=torch.int64, device=points.device)
    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    extent = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    q = ((points - lo) / extent * 1023.0).to(torch.int64).clamp(0, 1023)
    code = (
        _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)
    )
    return torch.argsort(code, stable=True)


def _morton_perm(triangle_vertices: torch.Tensor) -> torch.Tensor:
    """Permutation sorting triangles by their centroids along a Morton curve."""
    return morton_perm_points(triangle_vertices.mean(dim=1))


def _chunk_aabbs(tris: torch.Tensor, active: torch.Tensor, chunk: int = T_SUB) -> torch.Tensor:
    """Per-``chunk`` AABBs of the padded ``[9, T]`` v0/e1/e2 layout (the BVH's leaf boxes).

    ``active`` is the padded ``[1, T]`` int mask. Returns ``[8, T // chunk]``:
    rows 0-2 min xyz, rows 3-5 max xyz (with a relative margin, so that
    rounding never culls a grazing hit), rows 6-7 zero. Chunks with no
    active triangle get an inverted box.
    """
    v0 = tris[0:3]
    v1 = tris[0:3] + tris[3:6]
    v2 = tris[0:3] + tris[6:9]
    ok = active[0] > 0
    mn = torch.minimum(torch.minimum(v0, v1), v2)
    mx = torch.maximum(torch.maximum(v0, v1), v2)
    inf = torch.tensor(torch.inf, dtype=mn.dtype, device=mn.device)
    mn = torch.where(ok, mn, inf).reshape(3, -1, chunk).amin(dim=-1)
    mx = torch.where(ok, mx, -inf).reshape(3, -1, chunk).amax(dim=-1)
    extent = torch.where(torch.isfinite(mx), mx, -inf).max() - torch.where(
        torch.isfinite(mn), mn, inf
    ).min()
    margin = 1e-5 * torch.where(torch.isfinite(extent), extent.abs(), 0.0) + 1e-12
    aabb = torch.cat((mn - margin, mx + margin), dim=0)
    return torch.cat((aabb, torch.zeros_like(aabb[:2])), dim=0).to(torch.float32)


def _tile_aabbs(chunk_aabb: torch.Tensor, chunks_per_tile: int) -> torch.Tensor:
    """Fold ``[8, num_chunks]`` chunk AABBs up to ``[8, num_tiles]`` tile AABBs.

    A last, partial tile folds only the chunks it has. The BVH folds its
    levels with it, two children to a parent.
    """
    num_chunks = chunk_aabb.shape[1]
    pad = -num_chunks % chunks_per_tile
    lo = torch.nn.functional.pad(chunk_aabb[0:3], (0, pad), value=torch.inf)
    hi = torch.nn.functional.pad(chunk_aabb[3:6], (0, pad), value=-torch.inf)
    tiles = torch.cat(
        (
            lo.reshape(3, -1, chunks_per_tile).amin(dim=-1),
            hi.reshape(3, -1, chunks_per_tile).amax(dim=-1),
        )
    )
    return torch.cat((tiles, torch.zeros_like(tiles[:2])))


def _slab_overlap(o, d, box, t_hi) -> torch.Tensor:
    """Conservative segment-vs-AABB slab test (``csrc/mt.cuh::slab_overlap``).

    ``o`` and ``d`` are 3-lists of tensors, ``box`` a 6-list (min xyz, max
    xyz), ``t_hi`` the upper parameter bound. Never a false miss for a
    segment whose ``[0, t_hi]`` part touches the box.
    """
    tnear = torch.zeros_like(o[0])
    tfar = torch.broadcast_to(torch.as_tensor(t_hi, dtype=o[0].dtype), o[0].shape)
    for c in range(3):
        dc = d[c]
        tiny = torch.where(dc < 0.0, -_SLAB_TINY, _SLAB_TINY).to(dc.dtype)
        inv = 1.0 / torch.where(torch.abs(dc) < _SLAB_TINY, tiny, dc)
        t1 = (box[c] - o[c]) * inv
        t2 = (box[3 + c] - o[c]) * inv
        tnear = torch.maximum(tnear, torch.minimum(t1, t2))
        tfar = torch.minimum(tfar, torch.maximum(t1, t2))
    return tnear <= tfar


def ray_intersect_any_triangle_reference(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None = None,
    *,
    hit_threshold: torch.Tensor,
    epsilon: float | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the any-hit kernel, with the same contract.

    ``ray_origins`` and ``ray_directions`` are ``[R, 3]``, ``hit_threshold``
    ``[R]``: ray ``i`` is blocked when it hits an active triangle with
    ``epsilon < t < hit_threshold[i]``; a negative threshold marks an
    inactive ray, which is never blocked. Only the active rays are tested,
    against triangle tiles of at most ``_MAX_PAIRS`` ray-triangle pairs.
    """
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    out = torch.zeros(ray_origins.shape[0], dtype=torch.bool, device=ray_origins.device)
    live = torch.nonzero(hit_threshold >= 0.0).squeeze(-1)
    if live.numel() == 0:
        return out
    out[live] = any_hit_below(
        ray_origins[live],
        ray_directions[live],
        triangle_vertices,
        active_triangles,
        hit_threshold[live],
        epsilon=epsilon,
        tile=_MAX_PAIRS // live.shape[0],
    )
    return out


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if x.device != device:
        msg = f"{name} is on {x.device}, expected {device}."
        raise ValueError(msg)
    if x.dtype != dtype:
        msg = f"{name} has dtype {x.dtype}, expected {dtype}."
        raise TypeError(msg)
    if tuple(x.shape) != shape:
        msg = f"{name} has shape {tuple(x.shape)}, expected {shape}."
        raise ValueError(msg)
    if not x.is_contiguous():
        msg = f"{name} must be contiguous."
        raise ValueError(msg)


def ray_intersect_any_triangle_cuda(
    ray_origins: torch.Tensor,
    ray_directions: torch.Tensor,
    triangle_vertices: torch.Tensor | None,
    active_triangles: torch.Tensor | None = None,
    *,
    hit_threshold: torch.Tensor,
    epsilon: float | None = None,
    bvh=None,
) -> torch.Tensor:
    """Any-hit test on the CUDA kernel; see :func:`ray_intersect_any_triangle_reference`.

    Inputs are float32 ``[R, 3]`` rays, ``[T, 3, 3]`` triangles, an optional
    ``[T]`` bool mask and ``[R]`` thresholds, contiguous and on one device.
    ``bvh`` is the triangles' :class:`._bvh.MeshBVH` (``Mesh.bvh``); it is
    built here when not given, and with it the triangles may be None on
    CUDA. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise); other devices raise.
    """
    device = ray_origins.device
    if device.type == "cpu":
        return ray_intersect_any_triangle_reference(
            ray_origins,
            ray_directions,
            triangle_vertices,
            active_triangles,
            hit_threshold=hit_threshold,
            epsilon=epsilon,
        )
    if device.type != "cuda":
        msg = f"The any-hit kernel runs on CUDA tensors, not on {device}."
        raise ValueError(msg)
    num_rays = ray_origins.shape[0]
    _check("ray_origins", ray_origins, torch.float32, (num_rays, 3), device)
    _check("ray_directions", ray_directions, torch.float32, (num_rays, 3), device)
    _check("hit_threshold", hit_threshold, torch.float32, (num_rays,), device)
    bvh = checked_bvh(triangle_vertices, active_triangles, bvh, device)
    if epsilon is None:
        epsilon = 10.0 * F32_EPS

    out = torch.empty(num_rays, dtype=torch.bool, device=device)
    if num_rays:
        launch_anyhit(ray_origins, ray_directions, hit_threshold, bvh, epsilon, out)
    return out


def checked_bvh(triangle_vertices, active_triangles, bvh, device):
    """The wrappers' shared check of the mesh inputs: the given BVH, or one built here."""
    from ._bvh import build_bvh, check_bvh  # _bvh imports this module

    if triangle_vertices is not None:
        num_tris = triangle_vertices.shape[0]
        _check("triangle_vertices", triangle_vertices, torch.float32, (num_tris, 3, 3), device)
        if active_triangles is not None:
            _check("active_triangles", active_triangles, torch.bool, (num_tris,), device)
        if bvh is None:
            bvh = build_bvh(triangle_vertices, active_triangles)
    elif bvh is None:
        msg = "Give the triangles or their BVH."
        raise ValueError(msg)
    check_bvh(bvh, bvh.num_triangles if triangle_vertices is None else num_tris, device)
    return bvh


def anyhit_split(num_live: int, depth: int) -> int:
    """The tree level ``L`` at whose subtrees the any-hit kernel's work items start.

    The least ``L`` with ``num_live * 2**L`` at or above
    :data:`SPLIT_ITEMS`, at most the tree's ``depth`` (a subtree is then
    one leaf). ``L = 0`` is one walk of the whole tree per ray. The kernel
    applies this rule on the device to its count of live rays.

    >>> anyhit_split(128, 13), anyhit_split(262_144, 13), anyhit_split(1, 3)
    (10, 0, 3)
    """
    level = 0
    while level < depth and num_live << level < SPLIT_ITEMS:
        level += 1
    return level


def anyhit_items(num_live: int, split: int) -> int:
    """Work items of an any-hit launch: a live ray's subtrees at level ``split``, and its large list."""
    return num_live * ((1 << split) + (split > 0))


def launch_anyhit(
    ray_origins, ray_directions, hit_threshold, bvh, epsilon: float, out, *, split=None
) -> None:
    """Launch ``csrc/anyhit.cu`` on checked inputs (counted in :data:`LAUNCHES`).

    ``split`` forces the level of the items' subtree roots; by default the
    kernel picks it from its live count by :func:`anyhit_split`'s rule.
    Every level from 0 to ``bvh.depth`` gives the same result.
    """
    global LAUNCHES
    num_rays = ray_origins.shape[0]
    if split is None:
        split = -1
        most_items = num_rays + 2 * SPLIT_ITEMS  # the rule's most, whatever the live count
    elif 0 <= split <= bvh.depth:
        most_items = anyhit_items(num_rays, split)
    else:
        msg = f"split must be a level of the tree, 0 to {bvh.depth}, not {split}."
        raise ValueError(msg)
    if most_items > _MAX_ITEMS:
        msg = f"{num_rays} rays can make more than {_MAX_ITEMS} work items."
        raise ValueError(msg)
    # Two counters, then the list of live rays.
    scratch = torch.empty(2 + num_rays, dtype=torch.int32, device=out.device)
    status = load_kernels().differt_anyhit(
        ray_origins.data_ptr(),
        ray_directions.data_ptr(),
        hit_threshold.data_ptr(),
        bvh.nodes.data_ptr(),
        bvh.triangles.data_ptr(),
        bvh.num_nodes,
        bvh.large_begin,
        bvh.num_large,
        num_rays,
        split,
        SPLIT_ITEMS,
        epsilon,
        scratch.data_ptr(),
        out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream,
    )
    LAUNCHES += 1
    check_launch("differt_anyhit", status)
