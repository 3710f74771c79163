"""The kernels' acceleration structure: a BVH over the Morton order, built once per mesh.

The any-hit, closest-hit and fused trace kernels (``csrc/mt.cuh``) walk
this structure instead of a flat list of chunks. It is built in plain
PyTorch on the mesh's device, under ``torch.no_grad()``, and a
:class:`~differt_tpu_torch.geometry.Mesh` keeps the one built for it
(``Mesh.bvh``), so a path that queries the same mesh many times builds it
once.

Layout (the header of ``csrc/mt.cuh`` describes it for the kernels):

- Triangles are sorted along the Morton curve of their centroids
  (:func:`._rt._morton_perm`, the JAX package's permutation). A triangle's
  *Morton position* is its index in that order; the closest-hit tie key
  compares positions.
- Triangles whose bounding box is a large share of the mesh's
  (``LARGE_SHARE`` of its diagonal: the ground of a city) go in a short
  list that the kernels test before the tree, so that one huge leaf does
  not drag every ray down its branch, and so that a closest-hit query
  starts the walk with a best ``t``. At most ``MAX_LARGE`` are kept there,
  the largest first.
- The other triangles, in Morton order, fill leaves of ``leaf_size``
  consecutive triangles; a complete binary tree over the leaves (padded
  to a power of two with empty leaves) is stored in heap order. Leaf
  boxes carry the relative margin of :func:`._rt._chunk_aabbs`, inner
  boxes fold their children's with :func:`._rt._tile_aabbs`, so culling
  never misses a grazing hit. A node holding no active triangle is
  flagged and never entered.
"""

import dataclasses

import torch

from ._rt import _chunk_aabbs, _morton_perm, _tile_aabbs

LEAF_SIZE = 4
"""Triangles per leaf: of 4, 8 and 16, 4 was fastest for every kernel on the card (``PERF.md``)."""
LARGE_SHARE = 0.5
"""A triangle whose box diagonal exceeds this share of the mesh's goes in the large list."""
MAX_LARGE = 16
"""Most triangles the large list holds (the largest first)."""
MAX_DEPTH = 30
"""Deepest tree the kernels' traversal stack takes (``kMaxDepth`` in ``csrc/mt.cuh``)."""
LEAF, ALIVE = 1, 2
"""Flag bits of a node's last word; a leaf's triangle count sits above them."""

BUILDS = 0
"""Structures built by :func:`build_bvh` in this process."""


@dataclasses.dataclass(frozen=True, eq=False)
class MeshBVH:
    """A mesh's BVH in the kernels' layout (see the module docstring)."""

    nodes: torch.Tensor
    """``[num_nodes, 8]`` float32: min xyz, link, max xyz, flags (link and flags are int32 bits)."""
    triangles: torch.Tensor
    """``[num_records, 12]`` float32: v0, e1, e2, active, Morton position (int32 bits), 0."""
    perm: torch.Tensor
    """``[num_triangles]`` int64: Morton position -> triangle index."""
    large_begin: int
    """Record index where the large-triangle list starts (after the leaves)."""
    num_large: int
    """Triangles in the large list."""
    depth: int
    """Levels below the root (the leaves' level)."""
    leaf_size: int
    """Triangle slots per leaf."""

    @property
    def num_triangles(self) -> int:
        return self.perm.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def positions(self) -> torch.Tensor:
        """``[num_triangles]`` int64: triangle index -> Morton position (the inverse of :attr:`perm`)."""
        pos = torch.empty_like(self.perm)
        pos[self.perm] = torch.arange(self.perm.shape[0], device=self.perm.device)
        return pos

    @property
    def nbytes(self) -> int:
        """Bytes of the structure (nodes and triangle records)."""
        return self.nodes.numel() * 4 + self.triangles.numel() * 4


def _large_positions(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Morton positions (ascending) of the large-list triangles, from per-triangle boxes."""
    if lo.shape[0] == 0:
        return torch.empty(0, dtype=torch.int64, device=lo.device)
    diag = (hi - lo).norm(dim=-1)
    scene = (hi.amax(dim=0) - lo.amin(dim=0)).norm()
    large = torch.nonzero(diag > LARGE_SHARE * scene).squeeze(-1)
    if large.shape[0] > MAX_LARGE:
        large = large[torch.topk(diag[large], MAX_LARGE).indices]
    return torch.sort(large).values


def build_bvh(
    triangle_vertices: torch.Tensor,
    active_triangles: torch.Tensor | None = None,
    *,
    leaf_size: int = LEAF_SIZE,
) -> MeshBVH:
    """Build the BVH of ``[T, 3, 3]`` triangles and an optional ``[T]`` bool mask.

    Runs on the triangles' device, a few dozen PyTorch ops and one
    host synchronisation (the size of the large list). Counted in
    :data:`BUILDS`.

    >>> import torch
    >>> from differt_tpu_torch.geometry import Mesh
    >>> bvh = build_bvh(Mesh.box(with_top=True, device="cpu").triangle_vertices)
    >>> bvh.num_large, bvh.num_nodes  # every face of a box is a large share of it
    (12, 1)
    """
    global BUILDS
    BUILDS += 1
    with torch.no_grad():
        tv = triangle_vertices.detach().to(torch.float32)
        device = tv.device
        num = tv.shape[0]
        perm = _morton_perm(tv)
        tv = tv[perm]
        if active_triangles is None:
            active = torch.ones(num, dtype=torch.float32, device=device)
        else:
            active = active_triangles[perm].to(torch.float32)

        v0 = tv[:, 0]
        records = torch.zeros((num, 12), dtype=torch.float32, device=device)
        records[:, 0:3] = v0
        records[:, 3:6] = tv[:, 1] - v0
        records[:, 6:9] = tv[:, 2] - v0
        records[:, 9] = active
        records.view(torch.int32)[:, 10] = torch.arange(num, dtype=torch.int32, device=device)

        large = _large_positions(tv.amin(dim=1), tv.amax(dim=1))
        in_tree = torch.ones(num, dtype=torch.bool, device=device)
        in_tree[large] = False
        tree = records[in_tree]
        num_tree = tree.shape[0]
        num_leaves = max(-(-num_tree // leaf_size), 1)
        width = 1 << (num_leaves - 1).bit_length()  # leaves padded to a power of two
        depth = width.bit_length() - 1
        tree = torch.nn.functional.pad(tree, (0, 0, 0, num_leaves * leaf_size - num_tree))

        # Leaf boxes and flags, padded to `width` with empty (inverted) leaves.
        boxes = _chunk_aabbs(tree[:, :9].T, tree[:, 9][None], chunk=leaf_size)
        pad = width - num_leaves
        boxes = torch.cat(
            (
                torch.nn.functional.pad(boxes[0:3], (0, pad), value=torch.inf),
                torch.nn.functional.pad(boxes[3:6], (0, pad), value=-torch.inf),
                torch.zeros((2, width), dtype=torch.float32, device=device),
            )
        )
        alive = torch.nn.functional.pad((tree[:, 9].reshape(-1, leaf_size) > 0).any(dim=-1), (0, pad))
        counts = (num_tree - leaf_size * torch.arange(width, device=device)).clamp(0, leaf_size)
        levels, alives = [boxes], [alive]
        while levels[-1].shape[1] > 1:
            levels.append(_tile_aabbs(levels[-1], 2))
            alives.append(alives[-1].reshape(-1, 2).any(dim=-1))
        box = torch.cat(levels[::-1], dim=1)  # heap order: root first
        alive = torch.cat(alives[::-1])

        num_nodes = 2 * width - 1
        heap = torch.arange(num_nodes, device=device)
        is_leaf = heap >= width - 1
        leaf_index = (heap - (width - 1)).clamp(min=0)
        link = torch.where(is_leaf, leaf_index * leaf_size, 2 * heap + 1)
        count = torch.where(is_leaf, counts[leaf_index], 0)
        flags = (count << 2) | (alive.to(torch.int64) * ALIVE) | (is_leaf.to(torch.int64) * LEAF)

        nodes = torch.empty((num_nodes, 8), dtype=torch.float32, device=device)
        nodes[:, 0:3] = box[0:3].T
        nodes[:, 4:7] = box[3:6].T
        words = nodes.view(torch.int32)
        words[:, 3] = link.to(torch.int32)
        words[:, 7] = flags.to(torch.int32)

        return MeshBVH(
            nodes=nodes.contiguous(),
            triangles=torch.cat((tree, records[large])).contiguous(),
            perm=perm,
            large_begin=num_leaves * leaf_size,
            num_large=large.shape[0],
            depth=depth,
            leaf_size=leaf_size,
        )


def check_bvh(bvh: MeshBVH, num_triangles: int, device: torch.device) -> None:
    """Raise if ``bvh`` cannot be the structure of ``num_triangles`` triangles on ``device``."""
    if bvh.num_triangles != num_triangles:
        msg = f"The BVH holds {bvh.num_triangles} triangles, expected {num_triangles}."
        raise ValueError(msg)
    if bvh.nodes.device != device or bvh.triangles.device != device:
        msg = f"The BVH is on {bvh.nodes.device}, expected {device}."
        raise ValueError(msg)
    if bvh.depth > MAX_DEPTH:
        msg = f"The BVH is {bvh.depth} levels deep; the kernels take at most {MAX_DEPTH}."
        raise ValueError(msg)
