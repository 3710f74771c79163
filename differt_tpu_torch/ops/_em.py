"""A coverage tile's Jones chain and per-pixel sum in one pass: the CUDA kernel's wrapper and its plain twin.

Replaces no TPU kernel: the JAX package leaves the chain
(``coverage.complex_amplitudes``) to XLA's fusion. On the card the port's
plain chain is some 700 elementwise launches a tile, each reading and
writing a whole ``[T, R, C]`` intermediate in device memory;
``csrc/em.cu`` reads each path's mask byte, and a valid path's vertices,
once, and writes one sum per pixel (see the kernel's header note).

:func:`em_tile_sum` computes what ``complex_amplitudes(...).sum(-1)``
computes on a traced tile (or, for an incoherent map, the sum of
``|a|^2``), with no gradient and no antenna pattern; the coverage tile
launches the kernel (:func:`em_laid_out`) on a candidate set's plan
(``coverage._tile_plan``). :func:`em_tile_sum_reference` is its contract
in plain PyTorch, written on ``complex_amplitudes``.
"""

import math

import torch

from ..em import epsilon_0
from ..profiling import annotate
from ._build import check_launch, load_kernels

LAUNCHES = 0
"""Calls of the CUDA EM tile kernel in this process (each one or two launches: the sum, then its splits')."""


def em_tile_sum_reference(
    vertices: torch.Tensor,
    mask: torch.Tensor,
    objects: torch.Tensor,
    interaction_types: torch.Tensor,
    mesh,
    frequency,
    *,
    eta_r: torch.Tensor,
    conductivity: torch.Tensor,
    thickness: torch.Tensor | None = None,
    coherent: bool = True,
) -> torch.Tensor:
    """The EM tile kernel's contract in plain PyTorch: ``complex_amplitudes`` summed per pixel.

    ``vertices [T, R, C, k + 2, 3]`` and ``mask [T, R, C]`` (bool) as a
    traced tile holds them (``TracedPaths``; the trace writes them
    ``[T, C, R, ...]``, and this is its transposed view), ``objects`` and
    ``interaction_types [C, k]`` each candidate's rows
    (``rt._solvers.candidate_rows``), ``mesh`` the scene's mesh. Returns the
    complex amplitude sum ``[T, R]`` (``coherent``) or the sum of the
    amplitudes' squared magnitudes.
    """
    from ..coverage import complex_amplitudes
    from ..geometry import Scene
    from ..rt._solvers import _assemble_traced_paths

    num_tx, num_rx, num_cand, length = vertices.shape[:4]
    paths = _assemble_traced_paths(
        vertices, mask, objects, interaction_types, 1, num_tx, num_rx, num_cand, length - 2
    )
    a = complex_amplitudes(
        paths,
        Scene(mesh=mesh),
        frequency,
        eta_r=eta_r,
        conductivity=conductivity,
        thickness=thickness,
    )
    if coherent:
        return a.sum(dim=-1)
    return (torch.abs(a) ** 2).sum(dim=-1)


def _material_table(frequency: torch.Tensor, eta_r, conductivity, thickness, device) -> torch.Tensor:
    """``[M, 3]``: each material's refractive index (real, imaginary) and thickness (-1: a half-space).

    The arithmetic of ``complex_amplitudes``, so that the kernel reads the
    same bits.
    """
    eta_r = torch.as_tensor(eta_r, dtype=torch.float32, device=device)
    conductivity = torch.as_tensor(conductivity, dtype=torch.float32, device=device)
    omega = 2.0 * math.pi * frequency
    n_complex = torch.sqrt(eta_r - 1j * conductivity / (omega * epsilon_0))
    if thickness is None:
        thickness = torch.full_like(eta_r, -1.0)
    else:
        thickness = torch.as_tensor(thickness, dtype=torch.float32, device=device)
    return torch.stack(
        (n_complex.real, n_complex.imag, thickness.expand(n_complex.shape)), dim=-1
    ).contiguous()


def em_tile_sum(
    vertices: torch.Tensor,
    mask: torch.Tensor,
    objects: torch.Tensor,
    interaction_types: torch.Tensor,
    mesh,
    frequency,
    *,
    eta_r: torch.Tensor,
    conductivity: torch.Tensor,
    thickness: torch.Tensor | None = None,
    coherent: bool = True,
) -> torch.Tensor:
    """The EM tile kernel (``csrc/em.cu``); see :func:`em_tile_sum_reference`.

    CUDA tensors only (the coverage tile runs the plain chain elsewhere),
    orders 0 to :data:`._trace.MAX_ORDER`. The vertices and the mask may
    take any strides over their TX, RX and candidate axes; the kernel reads
    them where they lie, which is coalesced in the trace's own layout. No
    gradient flows through the result. Lays its inputs out
    (:func:`em_rows`, :func:`em_mesh_inputs`) and launches
    (:func:`em_laid_out`).
    """
    device = vertices.device
    return em_laid_out(
        vertices,
        mask,
        *em_rows(objects, interaction_types, device),
        *em_mesh_inputs(mesh, frequency, eta_r, conductivity, thickness, device),
        coherent=coherent,
    )


def em_rows(objects: torch.Tensor, interaction_types: torch.Tensor, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidates' objects and interaction types ``[C, k]`` as the kernel reads them: int64 and int32, contiguous.

    Row by row, so a slice of a set's rows is the rows of the slice.
    """
    objects = objects.to(device=device, dtype=torch.int64).contiguous()
    types = interaction_types.to(device=device, dtype=torch.int32).contiguous()
    return objects, types


def em_mesh_inputs(
    mesh, frequency, eta_r, conductivity, thickness, device
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """What the kernel reads of the mesh and the call, which no tile changes.

    The mesh's normals (float32) and face materials (int64, or None), the
    material table (:func:`_material_table`) and the frequency (one float32
    on the device).
    """
    normals = mesh.normals.to(torch.float32).contiguous()
    face_materials = mesh.face_materials
    if face_materials is not None:
        face_materials = face_materials.to(torch.int64).contiguous()
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=device)
    table = _material_table(frequency, eta_r, conductivity, thickness, device)
    return normals, face_materials, table, frequency


def em_laid_out(
    vertices: torch.Tensor,
    mask: torch.Tensor,
    objects: torch.Tensor,
    types: torch.Tensor,
    normals: torch.Tensor,
    face_materials: torch.Tensor | None,
    table: torch.Tensor,
    frequency: torch.Tensor,
    *,
    coherent: bool,
) -> torch.Tensor:
    """The kernel on inputs laid out by :func:`em_rows` and :func:`em_mesh_inputs`: checks, one call.

    The launch half of every call of the kernel: :func:`em_tile_sum`, and a
    coverage tile whose rows and mesh inputs were laid out once for the
    whole candidate set (``coverage._coverage_tile`` on its set's plan).
    Counted in :data:`LAUNCHES`.
    """
    from ._rt import _check
    from ._trace import MAX_ORDER

    global LAUNCHES
    device = vertices.device
    if device.type != "cuda":
        msg = f"The EM tile kernel runs on CUDA tensors, not on {device}."
        raise ValueError(msg)
    num_tx, num_rx, num_cand, length, _ = vertices.shape
    order = length - 2
    if not 0 <= order <= MAX_ORDER:
        msg = f"The EM tile kernel takes orders 0 to {MAX_ORDER}, not {order}."
        raise ValueError(msg)
    if vertices.dtype != torch.float32:
        msg = f"vertices has dtype {vertices.dtype}, expected torch.float32."
        raise TypeError(msg)
    if vertices.stride(-1) != 1 or vertices.stride(-2) != 3:
        vertices = vertices.contiguous()
    if mask.dtype != torch.bool or tuple(mask.shape) != (num_tx, num_rx, num_cand):
        msg = f"mask must be bool of shape {(num_tx, num_rx, num_cand)}, got {mask.dtype} {tuple(mask.shape)}."
        raise ValueError(msg)
    _check("objects", objects, torch.int64, (num_cand, order), device)
    _check("interaction_types", types, torch.int32, (num_cand, order), device)

    out = torch.empty(
        (num_tx, num_rx), dtype=torch.complex64 if coherent else torch.float32, device=device
    )
    if out.numel() == 0:
        return out
    lib = load_kernels()
    splits = lib.differt_em_splits(num_tx, num_cand, num_rx)
    partial = None
    if splits > 1:
        partial = torch.empty((splits, *out.shape), dtype=out.dtype, device=device)
    with annotate("kernel.em"):
        status = lib.differt_em(
            vertices.data_ptr(),
            mask.data_ptr(),
            objects.data_ptr(),
            types.data_ptr(),
            normals.data_ptr(),
            None if face_materials is None else face_materials.data_ptr(),
            table.data_ptr(),
            table.shape[0],
            frequency.data_ptr(),
            order,
            num_tx,
            num_cand,
            num_rx,
            vertices.stride(0),
            vertices.stride(2),
            vertices.stride(1),
            mask.stride(0),
            mask.stride(2),
            mask.stride(1),
            int(coherent),
            None if partial is None else partial.data_ptr(),
            out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    LAUNCHES += 1
    check_launch("differt_em", status)
    return out
