"""The kernels' BVH (``differt_tpu_torch/ops/_bvh.py``), its cache on ``Mesh``, and the
repaired device defaults of the port's entry points.

The CUDA traversals (``csrc/mt.cuh``) cannot run here, so a line-for-line
Python model of them walks the BVH built on the CPU: its closest hits
must give the plain version's ``t`` exactly and the tie key's winner as
index, its any-hits the plain version's mask.
"""

import math

import numpy as np
import pytest
import torch

from differt_tpu_torch import scenes
from differt_tpu_torch.geometry import Mesh, fibonacci_lattice, generate_path_candidates
from differt_tpu_torch.interop import mesh_from_numpy, mesh_to_numpy
from differt_tpu_torch.ops import _bvh, _closest, _rt
from differt_tpu_torch.rt import ray_intersect_triangle

from .torch_parity import HIT_TOL, random_segments

torch.set_num_threads(1)

LEAF_SIZES = (4, 8, 16)


def _urban(masked: bool = False) -> Mesh:
    mesh = scenes.urban_scene(2, 2, device="cpu").mesh
    if masked:
        mesh = mesh.set_mask(torch.arange(mesh.num_triangles) % 3 != 0)
    return mesh


def _one_triangle() -> Mesh:
    return Mesh(
        vertices=torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.5]]),
        triangles=torch.tensor([[0, 1, 2]]),
    )


def _all_inactive() -> Mesh:
    mesh = scenes.street_canyon_scene(device="cpu").mesh
    return mesh.set_mask(torch.zeros(mesh.num_triangles, dtype=torch.bool))


def _many_boxes() -> Mesh:
    """60 boxes of growing length around one centre: more large triangles than the list holds."""
    mesh = Mesh.box(1.0, 1.0, 1.0, with_top=True, device="cpu")
    for i in range(1, 60):
        mesh = mesh + Mesh.box(1.0 + 0.1 * i, 1.0, 1.0, with_top=True, device="cpu")
    return mesh


MESHES = {
    "urban": _urban,
    "urban_masked": lambda: _urban(masked=True),
    "quads": lambda: _urban().set_assume_quads(),
    "one_triangle": _one_triangle,
    "all_inactive": _all_inactive,
    "boxes60": _many_boxes,
}


@pytest.fixture(params=list(MESHES))
def mesh(request) -> Mesh:
    return MESHES[request.param]()


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _leaves(bvh: _bvh.MeshBVH) -> tuple[torch.Tensor, torch.Tensor]:
    """The leaves' nodes and their first record."""
    leaves = bvh.nodes[-(1 << bvh.depth) :]
    return leaves, _words(leaves)[:, 3].long()


@pytest.mark.parametrize("leaf_size", LEAF_SIZES)
def test_every_triangle_in_one_leaf_or_the_large_list(mesh: Mesh, leaf_size: int) -> None:
    bvh = _bvh.build_bvh(mesh.triangle_vertices, mesh.mask, leaf_size=leaf_size)
    pos = _words(bvh.triangles)[:, 10].long()
    leaves, first = _leaves(bvh)
    counts = _words(leaves)[:, 7].long() >> 2
    held = [pos[f : f + n] for f, n in zip(first.tolist(), counts.tolist(), strict=True)]
    held.append(pos[bvh.large_begin : bvh.large_begin + bvh.num_large])
    held = torch.cat(held)
    assert torch.equal(torch.sort(held).values, torch.arange(mesh.num_triangles))
    assert bvh.num_large <= _bvh.MAX_LARGE
    assert bvh.triangles.shape[0] == bvh.large_begin + bvh.num_large
    assert int(counts.max()) <= leaf_size and bvh.nodes.shape == (2 * leaves.shape[0] - 1, 8)


@pytest.mark.parametrize("leaf_size", LEAF_SIZES)
def test_node_boxes_contain_children_and_triangles(mesh: Mesh, leaf_size: int) -> None:
    bvh = _bvh.build_bvh(mesh.triangle_vertices, mesh.mask, leaf_size=leaf_size)
    nodes, words = bvh.nodes, _words(bvh.nodes)
    inner = torch.nonzero((words[:, 7] & _bvh.LEAF) == 0).squeeze(-1)
    for side in (0, 1):
        child = words[inner, 3].long() + side
        alive = (words[child, 7] & _bvh.ALIVE) > 0
        parent, child = inner[alive], child[alive]
        assert (nodes[child, :3] >= nodes[parent, :3]).all()
        assert (nodes[child, 4:7] <= nodes[parent, 4:7]).all()
    # Each active tree triangle's corners lie in its leaf's box (margin included).
    tris = bvh.triangles[: bvh.large_begin]
    live = torch.nonzero(tris[:, 9] > 0).squeeze(-1)
    corners = torch.stack(
        (tris[live, :3], tris[live, :3] + tris[live, 3:6], tris[live, :3] + tris[live, 6:9]), 1
    )
    leaves, _ = _leaves(bvh)
    box = leaves[live // leaf_size]
    assert (corners >= box[:, None, :3]).all() and (corners <= box[:, None, 4:7]).all()


@pytest.mark.parametrize("leaf_size", LEAF_SIZES)
def test_positions_invert_the_morton_permutation(mesh: Mesh, leaf_size: int) -> None:
    tv = mesh.triangle_vertices
    bvh = _bvh.build_bvh(tv, mesh.mask, leaf_size=leaf_size)
    perm = _rt._morton_perm(tv)
    assert torch.equal(bvh.perm, perm)
    assert torch.equal(bvh.positions[perm], torch.arange(mesh.num_triangles))
    index = torch.arange(bvh.triangles.shape[0])
    real = (index < mesh.num_triangles - bvh.num_large) | (index >= bvh.large_begin)
    rec = bvh.triangles[real]
    triangle = perm[_words(rec)[:, 10].long()]
    torch.testing.assert_close(rec[:, 0:3], tv[triangle, 0], rtol=0, atol=0)
    torch.testing.assert_close(rec[:, 3:6], tv[triangle, 1] - tv[triangle, 0], rtol=0, atol=0)
    torch.testing.assert_close(rec[:, 6:9], tv[triangle, 2] - tv[triangle, 0], rtol=0, atol=0)
    active = torch.ones(mesh.num_triangles, dtype=torch.bool) if mesh.mask is None else mesh.mask
    assert torch.equal(rec[:, 9] > 0, active[triangle])
    assert not bvh.triangles[~real, 9].any()


@pytest.mark.parametrize("leaf_size", LEAF_SIZES)
def test_inactive_only_nodes_are_flagged(mesh: Mesh, leaf_size: int) -> None:
    bvh = _bvh.build_bvh(mesh.triangle_vertices, mesh.mask, leaf_size=leaf_size)
    words = _words(bvh.nodes)
    flags = words[:, 7]
    leaves, first = _leaves(bvh)
    leaf_flags = _words(leaves)[:, 7]
    active = bvh.triangles[:, 9] > 0
    leaf_alive = torch.tensor(
        [bool(active[f : f + (w >> 2)].any()) for f, w in zip(first.tolist(), leaf_flags.tolist())]
    )
    assert torch.equal((leaf_flags & _bvh.ALIVE) > 0, leaf_alive)
    # An inner node is alive exactly when one of its children is.
    inner = torch.nonzero((flags & _bvh.LEAF) == 0).squeeze(-1)
    child = words[inner, 3].long()
    either = ((flags[child] | flags[child + 1]) & _bvh.ALIVE) > 0
    assert torch.equal((flags[inner] & _bvh.ALIVE) > 0, either)
    if mesh.mask is not None and not mesh.mask.any():
        assert not ((flags & _bvh.ALIVE) > 0).any()


def test_large_list_holds_the_ground() -> None:
    mesh = scenes.urban_scene(3, 2, device="cpu").mesh
    bvh = mesh.bvh
    ground = torch.arange(mesh.num_triangles - 2, mesh.num_triangles)
    assert bvh.num_large == 2
    large = _words(bvh.triangles[bvh.large_begin :])[:, 10].long()
    assert torch.equal(torch.sort(bvh.perm[large]).values, ground)


# -- The cache on Mesh ----------------------------------------------------------


def test_bvh_is_built_once_per_mesh() -> None:
    mesh = _urban()
    builds = _bvh.BUILDS
    first = mesh.bvh
    assert mesh.bvh is first and mesh.bvh is first
    assert _bvh.BUILDS == builds + 1


def test_bvh_rebuilds_after_an_in_place_edit() -> None:
    mesh = _urban()
    first = mesh.bvh
    with torch.no_grad():
        mesh.vertices[0] += 1.0
    builds = _bvh.BUILDS
    second = mesh.bvh
    assert second is not first and _bvh.BUILDS == builds + 1
    torch.testing.assert_close(second.nodes, _bvh.build_bvh(mesh.triangle_vertices).nodes)
    assert mesh.bvh is second


def test_bvh_rebuilds_after_an_in_place_mask_edit() -> None:
    mesh = _urban(masked=True)
    first = mesh.bvh
    mesh.mask[:] = True
    assert mesh.bvh is not first
    assert bool((mesh.bvh.triangles[:, 9] > 0).sum() == mesh.num_triangles)


@pytest.mark.parametrize(
    "edit",
    [
        lambda m: m.translate([1.0, 2.0, 3.0]),
        lambda m: m + Mesh.box(device="cpu"),
        lambda m: m.set_mask(torch.ones(m.num_triangles, dtype=torch.bool)),
        lambda m: m.set_materials("Glass"),
    ],
    ids=["translate", "append", "set_mask", "set_materials"],
)
def test_new_meshes_start_without_a_bvh(edit) -> None:
    mesh = _urban()
    first = mesh.bvh
    new = edit(mesh)
    assert new._bvh is None
    assert new.bvh is not first
    assert mesh.bvh is first


def test_bvh_is_not_compared_or_shown() -> None:
    a, b = _urban(), _urban()
    a.bvh  # noqa: B018
    assert "_bvh" not in repr(a)
    assert a.bvh.num_triangles == b.num_triangles


def test_wrappers_check_a_given_bvh() -> None:
    tv = _urban().triangle_vertices
    bvh = _bvh.build_bvh(tv)
    with pytest.raises(ValueError, match="holds"):
        _bvh.check_bvh(bvh, tv.shape[0] + 1, tv.device)
    with pytest.raises(ValueError, match="on cpu"):
        _bvh.check_bvh(bvh, tv.shape[0], torch.device("meta"))
    deep = _bvh.MeshBVH(
        bvh.nodes, bvh.triangles, bvh.perm, bvh.large_begin, bvh.num_large,
        _bvh.MAX_DEPTH + 1, bvh.leaf_size,
    )
    with pytest.raises(ValueError, match="levels deep"):
        _bvh.check_bvh(deep, tv.shape[0], tv.device)
    with pytest.raises(ValueError, match="triangles or their BVH"):
        _rt.checked_bvh(None, None, None, tv.device)


# -- Entry points default to the card ------------------------------------------


@pytest.mark.parametrize(
    "call",
    [
        lambda: scenes.urban_scene(2, 2),
        lambda: scenes.street_canyon_scene(),
        lambda: Mesh.empty(),
        lambda: Mesh.box(),
        lambda: Mesh.plane([0.0, 0.0, 0.0], normal=[0.0, 0.0, 1.0]),
        lambda: generate_path_candidates(5, 2),
        lambda: fibonacci_lattice(16),
        lambda: mesh_from_numpy(mesh_to_numpy(_urban())),
    ],
    ids=["urban_scene", "street_canyon_scene", "empty", "box", "plane", "candidates",
         "lattice", "interop"],
)
def test_entry_points_ask_for_the_card(call) -> None:
    if torch.cuda.is_available():
        assert call() is not None
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        call()


def test_urban_scene_builds_its_template_on_the_cpu() -> None:
    # The numpy step needs CPU tensors, whatever device the scene goes to.
    mesh = scenes.urban_scene(2, 2, device="cpu").mesh
    assert mesh.device.type == "cpu" and mesh.num_triangles == 146


# -- A Python model of the kernels' traversals (csrc/mt.cuh) --------------------


class _Model:
    """``mt.cuh::walk_tree``, ``any_hit`` and ``closest_hit``, step for step, in float32."""

    def __init__(self, bvh: _bvh.MeshBVH, tv: torch.Tensor, eps: float) -> None:
        self.bvh, self.eps = bvh, eps
        self.nodes = bvh.nodes.numpy()
        self.words = _words(bvh.nodes).numpy()
        self.active = bvh.triangles[:, 9].numpy() > 0
        self.pos = _words(bvh.triangles)[:, 10].numpy()
        self.tv = tv  # indexed by triangle: record -> perm[pos]
        self.perm = bvh.perm.numpy()

    def _test(self, o, d, records: range):
        """(t, hit, Morton position) of each record, as record_hit computes them."""
        records = np.asarray(list(records), dtype=np.int64)
        tri = torch.from_numpy(self.perm[self.pos[records]])
        t, hit = ray_intersect_triangle(
            torch.from_numpy(o)[None], torch.from_numpy(d)[None], self.tv[tri], epsilon=self.eps
        )
        return t.numpy(), hit.numpy() & self.active[records], self.pos[records]

    @staticmethod
    def _slab(o, inv, lo, hi, t_hi):
        t1, t2 = (lo - o) * inv, (hi - o) * inv
        tnear = np.float32(0.0)
        tfar = np.float32(t_hi)
        for c in range(3):
            tnear = np.fmax(tnear, np.fmin(t1[c], t2[c]))
            tfar = np.fmin(tfar, np.fmax(t1[c], t2[c]))
        return bool(tnear <= tfar), tnear

    def _walk(self, o, d, t_hi, visit_leaf, near_first: bool, root: int = 0) -> None:
        """``walk_tree`` from the root; from another node, ``SubtreeWalk`` (near_first False)."""
        tiny = np.float32(1e-30)
        inv = np.float32(1.0) / np.where(np.abs(d) < tiny, np.where(d < 0, -tiny, tiny), d)
        node = lambda i: (self.nodes[i, :3], self.nodes[i, 4:7], self.words[i, 3], self.words[i, 7])  # noqa: E731
        lo, hi, link, flags = node(root)
        ok, _ = self._slab(o, inv, lo, hi, t_hi())
        if not (flags & _bvh.ALIVE) or not ok:
            return
        stack = []
        while True:
            if flags & _bvh.LEAF:
                if visit_leaf(link, flags >> 2):
                    return
            else:
                alo, ahi, alink, fa = node(link)
                blo, bhi, blink, fb = node(link + 1)
                ha, ta = self._slab(o, inv, alo, ahi, t_hi()) if fa & _bvh.ALIVE else (False, 0)
                hb, tb = self._slab(o, inv, blo, bhi, t_hi()) if fb & _bvh.ALIVE else (False, 0)
                if ha and hb:
                    b_first = near_first and tb < ta
                    stack.append((alink, fa, ta) if b_first else (blink, fb, tb))
                    link, flags = (blink, fb) if b_first else (alink, fa)
                    continue
                if ha or hb:
                    link, flags = (alink, fa) if ha else (blink, fb)
                    continue
            while stack:
                link, flags, t = stack.pop()
                if t <= t_hi():
                    break
            else:
                return

    def any_hit(self, o, d, thresh: float) -> bool:
        large = range(self.bvh.large_begin, self.bvh.large_begin + self.bvh.num_large)
        t, hit, _ = self._test(o, d, large)
        if (hit & (t < thresh)).any():
            return True
        found = []

        def leaf(first, count):
            t, hit, _ = self._test(o, d, range(first, first + count))
            found.append(bool((hit & (t < thresh)).any()))
            return found[-1]

        self._walk(o, d, lambda: np.float32(thresh), leaf, near_first=False)
        return any(found)

    def record_hits(self, origins, directions, thresh) -> np.ndarray:
        """``[R, num_records]``: ``record_hit`` and ``t < thresh`` of every ray and record."""
        tri = torch.from_numpy(self.perm[self.pos])
        t, hit = ray_intersect_triangle(
            torch.from_numpy(origins)[:, None], torch.from_numpy(directions)[:, None],
            self.tv[tri][None], epsilon=self.eps,
        )
        return hit.numpy() & self.active[None] & (t.numpy() < thresh[:, None])

    def leaves_reached(self, o, d, thresh, root: int = 0) -> list[tuple[int, int]]:
        """(first record, count) of every leaf the any-hit walk from ``root`` reaches, without exiting."""
        leaves = []
        self._walk(o, d, lambda: np.float32(thresh), lambda f, n: leaves.append((f, n)), False, root)
        return leaves

    def split_any_hit(self, o, d, thresh, hits, split: int) -> tuple[bool, set]:
        """The any-hit kernel's items for one ray at level ``split``, their OR and the leaves reached.

        At ``split = 0`` the one item tests the large list, then walks the
        tree; above, the large list is an item and each subtree at level
        ``split`` another. ``hits`` is the ray's row of :meth:`record_hits`.
        """
        if not thresh >= 0:
            return False, set()
        large = bool(hits[self.bvh.large_begin : self.bvh.large_begin + self.bvh.num_large].any())
        first = (1 << split) - 1
        reached = set()
        for root in range(first, 2 * first + 1):
            reached.update(self.leaves_reached(o, d, thresh, root))
        return large or any(hits[f : f + n].any() for f, n in reached), reached

    def closest_hit(self, o, d) -> tuple[int, float]:
        best = [np.float32(np.inf), -1]

        def test(records):
            for t, hit, pos in zip(*self._test(o, d, records), strict=True):
                if not hit:
                    continue
                bt, bp = best
                closer = t < bt or (
                    t == bt and bp >= 0 and (pos // 64 > bp // 64 or (pos // 64 == bp // 64 and pos < bp))
                )
                if closer:
                    best[:] = [t, int(pos)]

        test(range(self.bvh.large_begin, self.bvh.large_begin + self.bvh.num_large))

        def leaf(first, count):
            test(range(first, first + count))
            return False

        self._walk(o, d, lambda: best[0], leaf, near_first=True)
        t, pos = best
        return (int(self.perm[pos]) if pos >= 0 else -1), float(t)


def _rays(mesh: Mesh, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Lattice rays from above the city and from street level, and random segments."""
    down = fibonacci_lattice(n, device="cpu") * 300.0
    o_down = torch.tensor([10.0, -20.0, 30.0]).expand(n, 3)
    street = fibonacci_lattice(n, device="cpu") * 300.0
    o_street = torch.tensor([0.0, 25.0, 1.5]).expand(n, 3)
    start, direction, _ = random_segments(mesh.bounding_box.numpy(), n, 3)
    origins = torch.cat((o_down, o_street, torch.from_numpy(start))).contiguous()
    directions = torch.cat((down, street, torch.from_numpy(direction))).contiguous()
    return origins, directions


@pytest.mark.parametrize("leaf_size", [5, 8, 16])
@pytest.mark.parametrize("name", ["urban", "urban_masked", "boxes60"])
def test_model_closest_hit_is_the_tie_key_winner(name: str, leaf_size: int) -> None:
    mesh = MESHES[name]()
    tv, active = mesh.triangle_vertices, mesh.mask
    bvh = _bvh.build_bvh(tv, active, leaf_size=leaf_size)
    origins, directions = _rays(mesh, 100)
    if name == "boxes60":  # from inside the boxes, where the walls coincide
        origins = origins * 0.002
    want_idx, want_t = _closest.first_triangle_hit_by_ray_reference(origins, directions, tv, active)
    winner = _closest.tie_key_winner(origins, directions, tv, active, want_t, bvh.positions)
    model = _Model(bvh, tv, 10.0 * float(np.finfo(np.float32).eps))
    got = [model.closest_hit(o, d) for o, d in zip(origins.numpy(), directions.numpy())]
    idx = torch.tensor([g[0] for g in got])
    t = torch.tensor([g[1] for g in got], dtype=torch.float32)
    assert torch.equal(t, want_t)
    assert torch.equal(idx, winner)
    assert int((idx >= 0).sum()) > 0
    if name != "boxes60":  # rays from inside the boxes all hit
        assert int((idx < 0).sum()) > 0
    # The winner is a true tie of the plain version's answer.
    assert torch.equal(winner >= 0, want_idx >= 0)
    if name == "boxes60":
        assert int((winner != want_idx).sum()) > 0  # the two tie rules differ here


@pytest.mark.parametrize("leaf_size", [5, 8])
@pytest.mark.parametrize("name", ["urban", "urban_masked"])
def test_model_any_hit_equals_the_plain_version(name: str, leaf_size: int) -> None:
    mesh = MESHES[name]()
    tv, active = mesh.triangle_vertices, mesh.mask
    bvh = _bvh.build_bvh(tv, active, leaf_size=leaf_size)
    start, direction, live = random_segments(mesh.bounding_box.numpy(), 300, 9)
    thresh = np.where(live, 1.0 - 2.0 * HIT_TOL, -1.0).astype(np.float32)
    want = _rt.ray_intersect_any_triangle_reference(
        torch.from_numpy(start), torch.from_numpy(direction), tv, active,
        hit_threshold=torch.from_numpy(thresh),
    )
    model = _Model(bvh, tv, 10.0 * float(np.finfo(np.float32).eps))
    got = torch.tensor([
        bool(th >= 0) and model.any_hit(o, d, th)
        for o, d, th in zip(start, direction, thresh, strict=True)
    ])
    assert torch.equal(got, want)
    assert 0 < int(got.sum()) < int(live.sum())


@pytest.mark.parametrize("leaf_size", LEAF_SIZES)
def test_model_split_any_hit_equals_the_whole_walk(mesh: Mesh, leaf_size: int) -> None:
    # The any-hit kernel's work items at every split level: the OR over the
    # large list and the level's subtrees equals the walk from the root and
    # the plain version, and the subtrees reach every leaf the root's walk
    # reaches (their ancestors' slab tests are skipped, never needed).
    tv, active = mesh.triangle_vertices, mesh.mask
    bvh = _bvh.build_bvh(tv, active, leaf_size=leaf_size)
    bbox = mesh.bounding_box.numpy()
    start, direction, live = random_segments(bbox, 48, 41)
    # Half the segments start near the mesh's centre, inside the boxes of boxes60.
    centre = bbox.mean(axis=0)
    start[::2] = centre + 0.05 * (start[::2] - centre)
    thresh = np.where(live, 1.0 - 2.0 * HIT_TOL, -1.0).astype(np.float32)
    thresh[:3] = np.nan  # inactive, as a negative threshold
    want = _rt.ray_intersect_any_triangle_reference(
        torch.from_numpy(start), torch.from_numpy(direction), tv, active,
        hit_threshold=torch.from_numpy(thresh),
    ).numpy()
    model = _Model(bvh, tv, 10.0 * float(np.finfo(np.float32).eps))
    hits = model.record_hits(start, direction, thresh)
    rays = list(zip(start, direction, thresh, hits, strict=True))
    whole = [bool(th >= 0) and model.any_hit(o, d, th) for o, d, th, _ in rays]
    np.testing.assert_array_equal(whole, want)
    for split in range(bvh.depth + 1):
        got = []
        for o, d, th, row in rays:
            hit, reached = model.split_any_hit(o, d, th, row, split)
            got.append(hit)
            if th >= 0:
                assert set(model.leaves_reached(o, d, th)) <= reached
        np.testing.assert_array_equal(got, want, err_msg=f"split level {split}")
    if mesh.mask is None or mesh.mask.any():
        assert want.any()


@pytest.mark.parametrize(
    ("num_rays", "name", "want"),
    [(1, None, 17), (128, None, 10), (262_144, None, 0), (128, "one_triangle", 0),
     (1, "all_inactive", None)],
    ids=["1_ray", "128_rays", "262144_rays", "one_leaf", "all_inactive"],
)
def test_anyhit_split_rule(num_rays: int, name: str | None, want: int | None) -> None:
    # The least level with num_rays * 2**L >= SPLIT_ITEMS (2**17), capped at
    # the tree's depth; deep enough a tree (20 levels) when no mesh is named.
    # The kernel applies it to its count of live rays.
    depth = 20 if name is None else MESHES[name]().bvh.depth
    split = _rt.anyhit_split(num_rays, depth)
    if want is None:  # capped: the all-inactive canyon is shallow
        want = depth
        assert num_rays << depth < _rt.SPLIT_ITEMS
    assert split == want
    assert 0 <= split <= depth
    assert split == depth or num_rays << split >= _rt.SPLIT_ITEMS
    assert split == 0 or num_rays << (split - 1) < _rt.SPLIT_ITEMS
    assert _rt.anyhit_items(num_rays, split) == num_rays * ((1 << split) + (split > 0))


def test_tie_key_winner_rule() -> None:
    # Four coincident triangles at Morton positions 3, 70, 65 and 130 would
    # tie; with 130 inactive, chunk 1 (positions 64-127) is the largest left
    # and 65 the smallest position in it.
    tri = torch.tensor([[[0.0, -1, -1], [0, 1, -1], [0, 0, 1]]]).expand(4, 3, 3).contiguous()
    origins = torch.tensor([[-1.0, 0.0, 0.0], [-1.0, 5.0, 0.0]])
    directions = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    active = torch.tensor([True, True, True, False])
    positions = torch.tensor([3, 70, 65, 130])
    _, best_t = _closest.first_triangle_hit_by_ray_reference(origins, directions, tri, active)
    winner = _closest.tie_key_winner(origins, directions, tri, active, best_t, positions)
    assert winner.tolist() == [2, -1]
    assert math.isinf(float(best_t[1]))
