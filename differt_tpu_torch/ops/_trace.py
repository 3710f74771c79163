"""Fused specular trace: the Hopper kernel's wrapper and its plain version.

Replaces the TPU kernel ``differt_tpu/ops/_pallas_trace.py::_trace_kernel``
(driver ``_pallas_trace_specular_impl``, entry ``pallas_trace_specular``)
with the hand-written CUDA kernel in ``differt_tpu_torch/csrc/trace.cu``.

What bounds it on the H100: its bytes, above all the ``(k+2)*12`` bytes of
vertices it writes per path; at city scale nearly every path fails the
cheap checks, so the few that survive walk the mesh's BVH for blockage.
The kernel tiles (TX, candidates, receivers), computes each candidate's
TX images once per block, stages the vertices in shared memory for
16-byte stores, and queues the surviving paths' segments so that whole
warps walk the BVH (see the kernel's header note). It takes every order
from 1 to :data:`MAX_ORDER`, the cap its shared memory sets, as the TPU
kernel's VMEM budget sets its own. The VMEM-driven tile pickers of the TPU
kernel (``_pick_tile_t``, ``_pick_c_tile``) have no counterpart here.

Gradients: :func:`trace_specular_cuda` goes through a
``torch.autograd.Function`` (the counterpart of the JAX package's custom
VJP, ``_make_trace_specular``). Its forward is the kernel (the plain
version for CPU tensors); its backward recomputes the vertices with
:func:`trace_vertices`, plain PyTorch and op for op the kernel's geometry
phase, and pulls the gradient through that to the TX, the RX and the
mirrors. The mask is boolean and the blockage sweep takes no part in the
backward.
"""

import torch

from ..rt._image_method import sign
from ..rt._triangle import ray_intersect_triangle
from ..geometry._vectors import _dot
from ..profiling import annotate
from ._build import check_launch, load_kernels
from ._rt import _check, checked_bvh, ray_intersect_any_triangle_reference

MAX_ORDER = 107
"""Highest order the CUDA kernel takes (``csrc/trace.cu``, ``kMaxOrder``).

Orders 1-4 have their own instantiations, every higher order one that takes
the order as an argument. The cap is what one block's shared memory holds:
20,452 + 1,968 k bytes with quads (the top of the tree, then the per-order
arrays), at most Hopper's 227 KB opt-in (232,448 bytes).
"""

LAUNCHES = 0
"""Launches of the CUDA trace kernel in this process."""
REFERENCE_CALLS = 0
"""Calls of :func:`trace_specular_reference` in this process."""


def _trace_geometry(
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    mirror_vertices: torch.Tensor,
    mirror_normals: torch.Tensor,
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """The kernel's geometry phase: the image method on ``[C, k, 3]`` mirrors.

    Returns the ``k + 2`` points of each path, each ``[Ntx, C, Nrx, 3]``,
    and ``invalid``: the paths with a segment parallel to a mirror it
    should cross. A parallel segment divides by 1, not by 0, so that
    neither the values nor their gradients turn non-finite there.
    """
    k = mirror_vertices.shape[1]
    # Forward pass: mirror images of each TX, [Ntx, C, 3].
    images = []
    img = tx_vertices[:, None, :]
    for b in range(k):
        mv = mirror_vertices[None, :, b, :]
        n = mirror_normals[None, :, b, :]
        d = _dot(img - mv, n)[..., None]
        img = img - 2.0 * d * n
        images.append(img)

    # Backward pass from each RX, [Ntx, C, Nrx, 3].
    points = [None] * k
    point = rx_vertices[None, None, :, :]
    invalid = torch.zeros((), dtype=torch.bool, device=tx_vertices.device)
    for b in reversed(range(k)):
        mv = mirror_vertices[None, :, None, b, :]
        n = mirror_normals[None, :, None, b, :]
        direction = images[b][:, :, None, :] - point
        dn = _dot(direction, n)
        vn = _dot(mv - point, n)
        parallel = dn == 0.0
        tt = vn / torch.where(parallel, torch.ones_like(dn), dn)
        invalid = invalid | (parallel & (vn != 0.0))
        point = point + direction * tt[..., None]
        points[b] = point

    shape = (tx_vertices.shape[0], mirror_vertices.shape[0], rx_vertices.shape[0], 3)
    chain = [tx_vertices[:, None, None, :].expand(shape)]
    chain += [p.expand(shape) for p in points]
    chain += [rx_vertices[None, None, :, :].expand(shape)]
    return chain, invalid


def trace_vertices(
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    mirror_vertices: torch.Tensor,
    mirror_normals: torch.Tensor,
) -> torch.Tensor:
    """The vertices the trace kernel writes, ``[Ntx, C, Nrx, k + 2, 3]``, in plain PyTorch.

    The differentiable recompute of the fused trace's backward (the JAX
    package's ``_xla_trace_vertices``): the same arithmetic as the kernel,
    which is built without fused multiply-adds so that the two agree.
    """
    chain, _ = _trace_geometry(tx_vertices, rx_vertices, mirror_vertices, mirror_normals)
    return torch.stack(chain, dim=-2)


def trace_specular_reference(
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    mirror_vertices: torch.Tensor,
    mirror_normals: torch.Tensor,
    candidate_triangles: torch.Tensor,
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None,
    *,
    order: int,
    epsilon: float,
    hit_tol: float,
    min_len: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused trace kernel, with its exact contract.

    Shapes: ``tx [Ntx, 3]``, ``rx [Nrx, 3]``, mirror vertices and normals
    ``[C, k, 3]``, candidate triangles ``[C, tpm * k, 3, 3]`` (``tpm`` = 1,
    or 2 for quads), mesh ``[T, 3, 3]`` and an optional ``[T]`` mask.
    Returns vertices ``[Ntx, C, Nrx, k + 2, 3]`` and mask ``[Ntx, C, Nrx]``.
    Like the kernel, invalid paths keep their raw, possibly non-finite,
    vertices (the unfused pipeline zeroes them instead).
    """
    global REFERENCE_CALLS
    REFERENCE_CALLS += 1
    k = order
    tpm = candidate_triangles.shape[1] // k

    chain, invalid = _trace_geometry(tx_vertices, rx_vertices, mirror_vertices, mirror_normals)
    shape = chain[0].shape
    vertices = torch.stack(chain, dim=-2)

    finite = ~invalid
    seg_valid = torch.ones((), dtype=torch.bool, device=tx_vertices.device)
    seg_origins, seg_directions = [], []
    for s in range(k + 1):
        o = chain[s]
        d = chain[s + 1] - chain[s]
        finite = finite & torch.isfinite(o).all(dim=-1) & torch.isfinite(d).all(dim=-1)
        seg_valid = seg_valid & ~(_dot(d, d) < min_len)
        o = torch.where(torch.isfinite(o), o, 0.0)
        d = torch.where(torch.isfinite(d), d, 0.0)
        seg_origins.append(o + d * hit_tol)
        seg_directions.append(d)

    inside = torch.ones((), dtype=torch.bool, device=tx_vertices.device)
    for b in range(k):
        o = chain[b]
        d = chain[b + 1] - chain[b]
        hit_any = torch.zeros((), dtype=torch.bool, device=tx_vertices.device)
        for j in range(tpm):
            tri = candidate_triangles[None, :, None, tpm * b + j]
            hit_any = hit_any | ray_intersect_triangle(o, d, tri, epsilon=epsilon)[1]
        inside = inside & hit_any

    same_side = torch.ones((), dtype=torch.bool, device=tx_vertices.device)
    for b in range(k):
        mv = mirror_vertices[None, :, None, b, :]
        n = mirror_normals[None, :, None, b, :]
        dot_prev = _dot(chain[b] - mv, n)
        dot_next = _dot(chain[b + 2] - mv, n)
        same_side = same_side & (sign(dot_prev) == sign(dot_next))

    geom = (inside & same_side & seg_valid & finite).expand(shape[:-1])
    # Blockage only for the paths that passed: the others start blocked.
    thresh = torch.where(
        geom,
        torch.tensor(1.0 - 2.0 * hit_tol, dtype=torch.float32, device=geom.device),
        -1.0,
    )
    blocked = ray_intersect_any_triangle_reference(
        torch.stack(seg_origins, dim=-2).reshape(-1, 3),
        torch.stack(seg_directions, dim=-2).reshape(-1, 3),
        triangle_vertices,
        active_triangles,
        hit_threshold=thresh[..., None].expand(*shape[:-1], k + 1).reshape(-1),
        epsilon=epsilon,
    ).reshape(*shape[:-1], k + 1)
    return vertices, geom & ~blocked.any(dim=-1)


def trace_specular_cuda(
    tx_vertices: torch.Tensor,
    rx_vertices: torch.Tensor,
    mirror_vertices: torch.Tensor,
    mirror_normals: torch.Tensor,
    candidate_triangles: torch.Tensor,
    triangle_vertices: torch.Tensor | None,
    active_triangles: torch.Tensor | None,
    *,
    order: int,
    epsilon: float,
    hit_tol: float,
    min_len: float,
    bvh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused trace on the CUDA kernel; see :func:`trace_specular_reference`.

    Inputs are float32 (the mask bool), contiguous and on one device.
    ``bvh`` is the mesh's :class:`._bvh.MeshBVH` (``Mesh.bvh``); it is
    built here when not given, and with it the mesh's triangles may be
    None on CUDA. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise); other devices raise.

    The vertices are differentiable with respect to the TX, the RX and the
    mirrors' vertices and normals (:class:`_TraceSpecular`); the candidate
    triangles, the mesh and the mask carry no gradient. Orders above
    :data:`MAX_ORDER` raise on every device.
    """
    if not 1 <= order <= MAX_ORDER:
        msg = f"The trace kernel takes orders 1 to {MAX_ORDER}, not {order}."
        raise ValueError(msg)
    return _TraceSpecular.apply(
        tx_vertices,
        rx_vertices,
        mirror_vertices,
        mirror_normals,
        candidate_triangles,
        triangle_vertices,
        active_triangles,
        bvh,
        order,
        epsilon,
        hit_tol,
        min_len,
    )


class _TraceSpecular(torch.autograd.Function):
    """The fused trace with a backward (``_make_trace_specular`` of the JAX package).

    The forward launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors, both outside the graph; only the TX, the RX
    and the mirrors are saved. The backward zeroes the non-finite entries
    of the incoming gradient (an invalid path's vertices may be
    non-finite, and so may what a caller derived from them), recomputes
    the vertices with :func:`trace_vertices` and differentiates that.
    """

    @staticmethod
    def forward(
        ctx, tx_vertices, rx_vertices, mirror_vertices, mirror_normals, candidate_triangles,
        triangle_vertices, active_triangles, bvh, order, epsilon, hit_tol, min_len,
    ):
        args = (
            tx_vertices,
            rx_vertices,
            mirror_vertices,
            mirror_normals,
            candidate_triangles,
            triangle_vertices,
            active_triangles,
        )
        kw = {"order": order, "epsilon": epsilon, "hit_tol": hit_tol, "min_len": min_len}
        if tx_vertices.device.type == "cpu":
            vertices, mask = trace_specular_reference(*args, **kw)
        else:
            vertices, mask = trace_laid_out(
                tx_vertices,
                rx_vertices,
                *trace_layout(mirror_vertices, mirror_normals, candidate_triangles),
                triangle_vertices,
                active_triangles,
                **kw,
                bvh=bvh,
            )
        ctx.save_for_backward(tx_vertices, rx_vertices, mirror_vertices, mirror_normals)
        ctx.mark_non_differentiable(mask)
        return vertices, mask

    @staticmethod
    def backward(ctx, grad_vertices, grad_mask):
        del grad_mask
        grad_vertices = torch.where(torch.isfinite(grad_vertices), grad_vertices, 0.0)
        needed = [i for i in range(4) if ctx.needs_input_grad[i]]
        grads = [None] * 12
        with torch.enable_grad():
            inputs = [
                x.detach().requires_grad_(i in needed) for i, x in enumerate(ctx.saved_tensors)
            ]
            vertices = trace_vertices(*inputs)
            for i, g in zip(
                needed, torch.autograd.grad(vertices, [inputs[i] for i in needed], grad_vertices)
            ):
                grads[i] = g
        return tuple(grads)


def trace_layout(
    mirror_vertices: torch.Tensor, mirror_normals: torch.Tensor, candidate_triangles: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's layout of ``[C, k, 3]`` mirrors and ``[C, tpm * k, 3, 3]`` candidate triangles.

    Returns ``mirrors [C, k, 6]`` (each mirror's vertex and normal) and
    ``cand_tris [C, tpm * k, 9]`` (each triangle's v0, e1, e2), contiguous.
    Candidate by candidate, so a slice of a set's layout is the layout of
    the slice, bit for bit.
    """
    mirrors = torch.cat((mirror_vertices, mirror_normals), dim=-1).contiguous()
    v0 = candidate_triangles[..., 0, :]
    cand_tris = torch.cat(
        (v0, candidate_triangles[..., 1, :] - v0, candidate_triangles[..., 2, :] - v0),
        dim=-1,
    ).contiguous()
    return mirrors, cand_tris


def trace_laid_out(
    tx_vertices, rx_vertices, mirrors, cand_tris, triangle_vertices, active_triangles, *,
    order: int, epsilon: float, hit_tol: float, min_len: float, bvh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Check the inputs laid out by :func:`trace_layout`, make fresh outputs and launch the kernel once.

    Returns vertices ``[Ntx, C, Nrx, k + 2, 3]`` and mask ``[Ntx, C, Nrx]``,
    as :func:`trace_specular_reference`; no gradient. The launch half of
    every call of the kernel: :func:`trace_specular_cuda`'s forward, and a
    coverage tile whose candidates were laid out once for the whole set
    (``coverage._coverage_tile`` on its set's plan).
    """
    device = tx_vertices.device
    if device.type != "cuda":
        msg = f"The trace kernel runs on CUDA tensors, not on {device}."
        raise ValueError(msg)
    num_tx, num_rx, num_cand = tx_vertices.shape[0], rx_vertices.shape[0], mirrors.shape[0]
    tpm = cand_tris.shape[1] // order
    if tpm not in (1, 2):
        msg = f"Expected 1 or 2 candidate triangles per mirror, got {tpm}."
        raise ValueError(msg)
    f32 = torch.float32
    _check("tx_vertices", tx_vertices, f32, (num_tx, 3), device)
    _check("rx_vertices", rx_vertices, f32, (num_rx, 3), device)
    _check("mirrors", mirrors, f32, (num_cand, order, 6), device)
    _check("cand_tris", cand_tris, f32, (num_cand, tpm * order, 9), device)
    bvh = checked_bvh(triangle_vertices, active_triangles, bvh, device)

    vertices = torch.empty((num_tx, num_cand, num_rx, order + 2, 3), dtype=f32, device=device)
    mask = torch.empty((num_tx, num_cand, num_rx), dtype=torch.bool, device=device)
    if mask.numel() == 0:
        return vertices, mask
    launch_trace(
        tx_vertices, rx_vertices, mirrors, cand_tris, bvh, order, tpm,
        epsilon, hit_tol, min_len, vertices, mask,
    )
    return vertices, mask


def launch_trace(
    tx_vertices, rx_vertices, mirrors, cand_tris, bvh, order: int, tpm: int,
    epsilon: float, hit_tol: float, min_len: float, vertices, mask,
) -> None:
    """Launch ``csrc/trace.cu`` on checked, prepared inputs (counted in :data:`LAUNCHES`).

    ``mirrors [C, k, 6]`` holds each mirror's vertex and normal,
    ``cand_tris [C, tpm * k, 9]`` each candidate triangle's v0, e1, e2.
    """
    global LAUNCHES
    lib = load_kernels()
    with annotate("kernel.trace"):
        status = lib.differt_trace(
            tx_vertices.data_ptr(),
            rx_vertices.data_ptr(),
            mirrors.data_ptr(),
            cand_tris.data_ptr(),
            bvh.nodes.data_ptr(),
            bvh.triangles.data_ptr(),
            order,
            tpm,
            tx_vertices.shape[0],
            mirrors.shape[0],
            rx_vertices.shape[0],
            bvh.num_nodes,
            bvh.large_begin,
            bvh.num_large,
            epsilon,
            hit_tol,
            1.0 - 2.0 * hit_tol,
            min_len,
            vertices.data_ptr(),
            mask.data_ptr(),
            torch.cuda.current_stream(mask.device).cuda_stream,
        )
    LAUNCHES += 1
    check_launch("differt_trace", status)
