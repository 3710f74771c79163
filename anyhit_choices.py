#!/usr/bin/env python3
"""Time the any-hit kernel at every split level on one NVIDIA GPU (Hopper, sm_90a),
beside the kernel of another checkout.

Run from the repository root, on a host with one H100:

    python3 anyhit_choices.py [--other DIR]

- Split level: the kernel alone (on the city's BVH, CUDA events) at every
  level ``L`` from 0 to the tree's depth, at the three shapes of
  ``chip_smoke.py`` phase 2 (262,144 random segments; the main path's 128
  order-0 segments; the unfused pipeline's first order-1 chunk, 1,048,576
  segments), each result checked equal to the plain version's. The level
  the kernel picks from its live count (``ops._rt.anyhit_split``'s rule,
  from ``SPLIT_ITEMS``) is marked.
- ``--other DIR``: the any-hit kernel of another checkout (for example the
  commit before the split, unpacked with ``git archive <commit> | tar -x -C
  DIR``), built from ``DIR/differt_tpu_torch/csrc/anyhit.cu`` with the same
  flags and its own C interface (one thread per ray), checked and timed at
  the same shapes, in turns with this checkout's kernel (other, this, this,
  other).

One line per measurement; any failure raises. ``chip_smoke.py`` checks the
kernels on the paths; this script only compares layouts.
"""

import argparse
import ctypes
import hashlib
from pathlib import Path

import torch

from chip_smoke import TRACE_KW, anyhit_shapes, cuda_ms, street_receivers


def other_anyhit(checkout: Path):
    """``launch(o, d, thresh, bvh, eps, out)`` of the other checkout's any-hit kernel,
    whose C interface is ``differt_anyhit(origins, directions, thresh, nodes, tris,
    num_nodes, large_begin, num_large, num_rays, epsilon, out, stream)``."""
    from differt_tpu_torch.ops import _build

    csrc = checkout / "differt_tpu_torch" / "csrc"
    source = csrc / "anyhit.cu"
    digest = hashlib.sha256(source.read_bytes() + (csrc / "mt.cuh").read_bytes()).hexdigest()
    lib_path = _build.BUILD_DIR / f"other_anyhit_{digest[:16]}.so"
    if not lib_path.is_file():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _build._run([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", f"-I{csrc}",
                      str(source), "-o", str(lib_path)]])
    fn = ctypes.CDLL(str(lib_path)).differt_anyhit
    fn.argtypes = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p,
    )
    fn.restype = ctypes.c_int

    def launch(o, d, th, bvh, eps, out):
        status = fn(o.data_ptr(), d.data_ptr(), th.data_ptr(), bvh.nodes.data_ptr(),
                    bvh.triangles.data_ptr(), bvh.num_nodes, bvh.large_begin, bvh.num_large,
                    o.shape[0], eps, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _build.check_launch("other differt_anyhit", status)

    return launch


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--other", type=Path, help="root of another checkout to compare with")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        msg = "anyhit_choices.py needs a CUDA device, and none is visible."
        raise SystemExit(msg)
    from differt_tpu_torch import scenes
    from differt_tpu_torch.geometry import Scene
    from differt_tpu_torch.ops import _rt

    device = torch.device("cuda", 0)
    eps = TRACE_KW["epsilon"]
    mesh = scenes.urban_scene(24, 24, device=device).mesh
    city = Scene(transmitters=torch.tensor([[0.0, 0.0, 40.0]], device=device),
                 receivers=street_receivers(device), mesh=mesh)
    tv = mesh.triangle_vertices.contiguous()
    bvh = mesh.bvh
    other = other_anyhit(args.other) if args.other else None
    for label, (o, d, th) in anyhit_shapes(city).items():
        num = o.shape[0]
        want = _rt.ray_intersect_any_triangle_reference(o, d, tv, None, hit_threshold=th)
        out = torch.empty_like(want)
        live = int((th >= 0).sum())
        picked = _rt.anyhit_split(live, bvh.depth)
        times = []
        for split in range(bvh.depth + 1):
            # The launch takes a forced level while every ray, live or not,
            # could make its items within the queue's count.
            if _rt.anyhit_items(live, split) > 1 << 26 or _rt.anyhit_items(num, split) > 1 << 30:
                break
            _rt.launch_anyhit(o, d, th, bvh, eps, out, split=split)
            if mismatches := int((out != want).sum()):
                msg = f"split level {split} disagrees on {mismatches} rays ({label})"
                raise AssertionError(msg)
            ms = cuda_ms(lambda s=split: _rt.launch_anyhit(o, d, th, bvh, eps, out, split=s), 20)
            times.append(f"{split}{'*' if split == picked else ''}:{ms:.4f}")
        print(f"anyhit {label}: rays={num} live={live} kernel_only_ms by split level (* picked): "
              + " ".join(times), flush=True)
        if other is None:
            continue
        other(o, d, th, bvh, eps, out)
        if mismatches := int((out != want).sum()):
            msg = f"the other checkout's kernel disagrees on {mismatches} rays ({label})"
            raise AssertionError(msg)
        turns = []
        for fn in (other, _rt.launch_anyhit, _rt.launch_anyhit, other):
            turns.append(cuda_ms(lambda fn=fn: fn(o, d, th, bvh, eps, out), 20))
        print(f"anyhit {label}: kernel_only_ms other / this / this / other:"
              f" {turns[0]:.4f} / {turns[1]:.4f} / {turns[2]:.4f} / {turns[3]:.4f}", flush=True)


if __name__ == "__main__":
    main()
