"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so that it runs on a GPU host without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Here (no CUDA device) every test skips.
"""

import numpy as np
import pytest
import torch

from differt_tpu_torch import scenes
from differt_tpu_torch.geometry import Scene, generate_path_candidates
from differt_tpu_torch.ops import _rt, _trace
from differt_tpu_torch.rt._solvers import candidate_geometry

from .torch_parity import EPSILON, HIT_TOL, cuda_or_skip, random_segments, triangle_mask

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("masked", [False, True])
def test_anyhit_kernel_matches_reference(masked: bool) -> None:
    device = cuda_or_skip()
    scene = scenes.urban_scene(4, 4, device=device)
    tv = scene.mesh.triangle_vertices.contiguous()
    bbox = scene.mesh.bounding_box.cpu().numpy()
    start, direction, active_rays = random_segments(bbox, 50_000, 23)
    active = torch.from_numpy(triangle_mask(tv.shape[0], 29)).to(device) if masked else None
    thresh = torch.from_numpy(
        np.where(active_rays, 1.0 - 2.0 * HIT_TOL, -1.0).astype(np.float32)
    ).to(device)
    args = (torch.from_numpy(start).to(device), torch.from_numpy(direction).to(device), tv, active)
    launches = _rt.LAUNCHES
    got = _rt.ray_intersect_any_triangle_cuda(*args, hit_threshold=thresh)
    torch.cuda.synchronize()
    assert _rt.LAUNCHES == launches + 1
    want = _rt.ray_intersect_any_triangle_reference(*args, hit_threshold=thresh)
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(active_rays.sum())


@pytest.mark.parametrize(("order", "quads"), [(1, False), (2, False), (2, True)])
def test_trace_kernel_matches_reference(order: int, quads: bool) -> None:
    device = cuda_or_skip()
    mesh = scenes.street_canyon_scene(device=device).mesh.set_assume_quads(quads)
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 0.0, 20.0], [10.0, 3.0, 5.0]], device=device),
        mesh=mesh,
    ).with_receivers_grid(16, 16)
    launches = _trace.LAUNCHES
    got = scene.trace_paths(order=order)  # megakernel=None picks the kernel on CUDA
    torch.cuda.synchronize()
    assert _trace.LAUNCHES == launches + 1

    candidates = generate_path_candidates(mesh.num_primitives, order, device=device)
    _, tris, mirror_vertices, mirror_normals = candidate_geometry(
        mesh, candidates * (2 if quads else 1)
    )
    args = (
        scene.transmitters.reshape(-1, 3),
        scene.receivers.reshape(-1, 3),
        mirror_vertices,
        mirror_normals,
        tris,
        mesh.triangle_vertices.contiguous(),
        None,
    )
    kw = {"order": order, "epsilon": EPSILON, "hit_tol": HIT_TOL, "min_len": EPSILON}
    verts, mask = _trace.trace_specular_cuda(*args, **kw)
    want_verts, want_mask = _trace.trace_specular_reference(*args, **kw)
    assert torch.equal(mask, want_mask)
    assert int(mask.sum()) > 0
    torch.testing.assert_close(verts[mask], want_verts[mask], atol=1e-4, rtol=0)
    # The public entry's [tx, rx..., cand] mask is the kernel's [tx, cand, rx].
    num_tx, num_cand, num_rx = mask.shape
    assert torch.equal(got.mask.reshape(num_tx, num_rx, num_cand).transpose(1, 2), mask)

    leaf = args[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="A8"):
        _trace.trace_specular_cuda(leaf, *args[1:], **kw)


def test_unfused_pipeline_uses_the_anyhit_kernel() -> None:
    device = cuda_or_skip()
    scene = Scene(
        transmitters=torch.tensor([[-30.0, 0.0, 20.0]], device=device),
        mesh=scenes.street_canyon_scene(device=device).mesh,
    ).with_receivers_grid(16, 16)
    launches, calls = _rt.LAUNCHES, _rt.REFERENCE_CALLS
    fused = scene.trace_paths(order=2)
    unfused = scene.trace_paths(order=2, megakernel=False)
    torch.cuda.synchronize()
    assert _rt.LAUNCHES == launches + 1 and _rt.REFERENCE_CALLS == calls
    assert torch.equal(fused.mask, unfused.mask)
