"""The card's peaks and the least time each kernel of the port could take (the yardstick).

Frozen from ``chip_smoke.py`` as of commit ``d3b5058``: ``bound``,
``mesh_bytes``, ``trace_flops`` and the byte count of ``trace_inputs``
(each input read once, each output written once), and the closest-hit
count of its phase 14 (origins and directions read, index and ``t``
written). A kernel's roofline share is its bound over its measured time.
"""

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_PER_S = 67e12  # float32 outside the tensor cores
MT_FLOPS = 51  # one Möller–Trumbore test: two crosses, four dots, a reciprocal, the checks


def bound_s(num_bytes: float, flops: float) -> float:
    """The larger of the bytes at peak bandwidth and the operations at peak rate, in seconds."""
    return max(num_bytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S)


def mesh_bytes(num_triangles: int) -> int:
    """A kernel function's mesh input: float32 ``[T, 3, 3]`` (no mask in these cells)."""
    return num_triangles * 36


def trace_flops(paths: int, order: int, tpm: int = 1) -> float:
    """Geometry operations of the fused trace: per mirror the backward step (23), ``tpm``
    Möller–Trumbore tests and the same-side check (16), per segment the length
    check (8). Blockage, which depends on the data, is not counted."""
    return paths * (order * (23 + MT_FLOPS * tpm + 16) + 8 * (order + 1))


def trace_launch_s(num_tx: int, num_candidates: int, num_rx: int, order: int, num_triangles: int, tpm: int = 1) -> float:
    """The bound of one ``trace.cu`` launch on a (TX, candidate chunk, RX tile) block.

    Read: TX and RX points, each candidate's mirror vertex and normal, its
    triangles' vertices, the mesh. Written: every path's ``k + 2`` vertices
    and its mask byte.
    """
    paths = num_tx * num_candidates * num_rx
    read = 12 * (num_tx + num_rx) + num_candidates * order * (24 + 36 * tpm) + mesh_bytes(num_triangles)
    written = paths * ((order + 2) * 12 + 1)
    return bound_s(read + written, trace_flops(paths, order, tpm))


def closest_launch_s(num_rays: int, num_triangles: int) -> float:
    """The bound of one ``closest.cu`` launch: origins and directions read, index and ``t`` written, the mesh."""
    return bound_s(num_rays * (24 + 8) + mesh_bytes(num_triangles), num_rays * MT_FLOPS)
