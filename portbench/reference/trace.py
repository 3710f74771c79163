"""Plain specular tracing: the image method, the checks and the blockage test (frozen).

The arithmetic is a copy of the port's plain trace as of commit
``d3b5058``: ``differt_tpu_torch/ops/_trace.py::_trace_geometry`` and
``trace_specular_reference`` (the fused kernel's contract),
``rt/_triangle.py::ray_intersect_triangle`` (hard branch),
``rt/_image_method.py::sign``, ``geometry/_vectors.py::_dot``/``_cross``,
``geometry/_mesh.py::Mesh.normals`` and, for the blockage,
``ops/_dispatch.py::anyhit_segments`` with ``rt/_scan.py::any_hit_below``.
Each operation is written out in the same order, so that float32 results
agree with the port's bit for bit where the port's kernels are built
without fused multiply-adds.

What is new here is only the order of the work: paths are traced in
blocks, only the paths that pass the cheap checks take the blockage test,
and that test skips the (segment, block of triangles) pairs whose boxes do
not meet. A skipped pair cannot hit: each box is the block's own,
widened by :data:`BOX_MARGIN`.
"""

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)
EPSILON = 10.0 * F32_EPS  # the intersection tests' t > epsilon
HIT_TOL = 100.0 * F32_EPS  # segments are shortened by this share at both ends
MIN_LEN = 10.0 * F32_EPS  # least squared segment length
BLOCK = 16  # triangles a box of the blockage test
BOX_MARGIN = 0.01  # m: each box is widened by this on every side
PATHS_A_BLOCK = 1 << 23  # (candidate, receiver) pairs traced at once
PAIRS_A_BLOCK = 1 << 25  # (segment, box) pairs held at once


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack(
        (
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ),
        dim=-1,
    )


def sign(x):
    return torch.where(torch.isnan(x), x, torch.sign(x))


def normals(triangle_vertices: torch.Tensor) -> torch.Tensor:
    """``[T, 3]`` unit normals, ``normalize(cross(v1 - v0, v2 - v1))``."""
    edges = triangle_vertices[:, 1:, :] - triangle_vertices[:, :-1, :]
    n = cross(edges[:, 0, :], edges[:, 1, :])
    length = torch.sqrt(dot(n, n))[..., None]
    return n / torch.where(length == 0.0, torch.ones_like(length), length)


def ray_triangle(o, d, tri, epsilon: float = EPSILON):
    """Möller–Trumbore: ``(t, hit)`` with ``hit`` inside the triangle and ``t > epsilon``."""
    v0 = tri[..., 0, :]
    edge_1 = tri[..., 1, :] - v0
    edge_2 = tri[..., 2, :] - v0
    h = cross(d, edge_2)
    det = dot(h, edge_1)
    parallel = det == 0.0
    inv_det = 1.0 / torch.where(parallel, torch.full_like(det, torch.inf), det)
    s = o - v0
    u = inv_det * dot(s, h)
    q = cross(s, edge_1)
    v = inv_det * dot(q, d)
    t = inv_det * dot(q, edge_2)
    hit = (torch.abs(det) > epsilon) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t > epsilon)
    return t, hit


def image_chain(tx, rx, mirror_vertices, mirror_normals):
    """The ``k + 2`` points of each path ``[Ntx, C, Nrx, 3]`` and whether a segment runs parallel to its mirror."""
    k = mirror_vertices.shape[1]
    images = []
    img = tx[:, None, :]
    for b in range(k):
        mv = mirror_vertices[None, :, b, :]
        n = mirror_normals[None, :, b, :]
        dd = dot(img - mv, n)[..., None]
        img = img - 2.0 * dd * n
        images.append(img)
    points = [None] * k
    point = rx[None, None, :, :]
    invalid = torch.zeros((), dtype=torch.bool, device=tx.device)
    for b in reversed(range(k)):
        mv = mirror_vertices[None, :, None, b, :]
        n = mirror_normals[None, :, None, b, :]
        direction = images[b][:, :, None, :] - point
        dn = dot(direction, n)
        vn = dot(mv - point, n)
        parallel = dn == 0.0
        tt = vn / torch.where(parallel, torch.ones_like(dn), dn)
        invalid = invalid | (parallel & (vn != 0.0))
        point = point + direction * tt[..., None]
        points[b] = point
    shape = (tx.shape[0], mirror_vertices.shape[0], rx.shape[0], 3)
    chain = [tx[:, None, None, :].expand(shape)]
    chain += [p.expand(shape) for p in points]
    chain += [rx[None, None, :, :].expand(shape)]
    return chain, invalid


def path_chain(tx, rx, mirror_vertices, mirror_normals):
    """:func:`image_chain` for single paths: ``tx [3]``, ``rx [P, 3]``, mirrors ``[P, k, 3]``; ``[P, k + 2, 3]``.

    The same operations on the same values, one path a row: the
    differentiable recompute of a gradient step.
    """
    k = mirror_vertices.shape[1]
    images = []
    img = tx.expand(rx.shape)
    for b in range(k):
        mv, n = mirror_vertices[:, b], mirror_normals[:, b]
        dd = dot(img - mv, n)[..., None]
        img = img - 2.0 * dd * n
        images.append(img)
    points = [None] * k
    point = rx
    for b in reversed(range(k)):
        mv, n = mirror_vertices[:, b], mirror_normals[:, b]
        direction = images[b] - point
        dn = dot(direction, n)
        vn = dot(mv - point, n)
        tt = vn / torch.where(dn == 0.0, torch.ones_like(dn), dn)
        point = point + direction * tt[..., None]
        points[b] = point
    return torch.stack([tx.expand(rx.shape), *points, rx], dim=-2)


class City:
    """A mesh as the reference sees it: triangles, normals and the boxes of its blocks."""

    def __init__(self, vertices: torch.Tensor, triangles: torch.Tensor, dtype=torch.float32):
        self.triangle_vertices = vertices.to(dtype)[triangles].contiguous()  # [T, 3, 3]
        self.normals = normals(self.triangle_vertices)
        num = self.triangle_vertices.shape[0]
        pad = -num % BLOCK
        tv = self.triangle_vertices
        if pad:
            tv = torch.cat((tv, tv[-1:].expand(pad, 3, 3)))
        self.blocked_tv = tv.reshape(-1, BLOCK, 3, 3)
        flat = self.blocked_tv.reshape(self.blocked_tv.shape[0], -1, 3).float()
        self.box_lo = flat.amin(dim=1) - BOX_MARGIN  # float32 boxes, whatever the dtype
        self.box_hi = flat.amax(dim=1) + BOX_MARGIN

    @property
    def num_triangles(self) -> int:
        return self.triangle_vertices.shape[0]


def _boxes_met(o, d, thr, lo, hi):
    """``[S, B]``: whether segment ``o + t d``, ``0 <= t <= thr``, meets box ``[lo, hi]``."""
    tnear = torch.zeros((o.shape[0], lo.shape[0]), device=o.device)
    tfar = thr[:, None].expand_as(tnear).clone()
    for c in range(3):
        dc = d[:, c : c + 1]
        tiny = torch.where(dc < 0.0, -1e-30, 1e-30)
        inv = 1.0 / torch.where(torch.abs(dc) < 1e-30, tiny, dc)
        t1 = (lo[None, :, c] - o[:, c : c + 1]) * inv
        t2 = (hi[None, :, c] - o[:, c : c + 1]) * inv
        tnear = torch.maximum(tnear, torch.minimum(t1, t2))
        tfar = torch.minimum(tfar, torch.maximum(t1, t2))
    return tnear <= tfar


def blocked(city: City, o: torch.Tensor, d: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    """``[S]``: whether each segment hits a triangle with ``epsilon < t < thr``."""
    num = o.shape[0]
    hits = torch.zeros(num, dtype=torch.int32, device=o.device)
    if num == 0:
        return hits > 0
    nb = city.box_lo.shape[0]
    step = max(1, PAIRS_A_BLOCK // nb)
    of, df, tf = o.float(), d.float(), thr.float()
    for lo in range(0, num, step):
        met = _boxes_met(of[lo : lo + step], df[lo : lo + step], tf[lo : lo + step], city.box_lo, city.box_hi)
        seg, box = torch.nonzero(met, as_tuple=True)
        seg = seg + lo
        for p0 in range(0, seg.shape[0], PAIRS_A_BLOCK // BLOCK):
            s, b = seg[p0 : p0 + PAIRS_A_BLOCK // BLOCK], box[p0 : p0 + PAIRS_A_BLOCK // BLOCK]
            t, hit = ray_triangle(o[s, None, :], d[s, None, :], city.blocked_tv[b])
            any_hit = ((t < thr[s, None]) & hit).any(dim=-1)
            hits.index_add_(0, s, any_hit.to(torch.int32))
    return hits > 0


def valid_paths(city: City, tx: torch.Tensor, rx: torch.Tensor, candidates: torch.Tensor):
    """The valid paths of ``[C, k]`` candidates from ``tx [1, 3]`` to ``rx [R, 3]``.

    Returns ``(rx_index [P], candidate_index [P], vertices [P, k + 2, 3])``
    in the city's dtype, ``k >= 0`` (order 0 is the direct path).
    """
    dtype = city.triangle_vertices.dtype
    tx, rx = tx.to(dtype), rx.to(dtype)
    num_c, k = candidates.shape
    num_r = rx.shape[0]
    found = ([], [], [])
    per = max(1, PATHS_A_BLOCK // max(num_r, 1))
    for c0 in range(0, num_c, per):
        cand = candidates[c0 : c0 + per]
        tris = city.triangle_vertices[cand]  # [C, k, 3, 3]
        mv = tris[:, :, 0, :]
        mn = city.normals[cand]
        chain, invalid = image_chain(tx, rx, mv, mn)
        finite = ~invalid
        seg_valid = torch.ones((), dtype=torch.bool, device=tx.device)
        for s in range(k + 1):
            o, dd = chain[s], chain[s + 1] - chain[s]
            finite = finite & torch.isfinite(o).all(dim=-1) & torch.isfinite(dd).all(dim=-1)
            seg_valid = seg_valid & ~(dot(dd, dd) < MIN_LEN)
        inside = torch.ones((), dtype=torch.bool, device=tx.device)
        same_side = torch.ones((), dtype=torch.bool, device=tx.device)
        for b in range(k):
            o, dd = chain[b], chain[b + 1] - chain[b]
            inside = inside & ray_triangle(o, dd, tris[None, :, None, b])[1]
            mvb, nb = mv[None, :, None, b, :], mn[None, :, None, b, :]
            same_side = same_side & (sign(dot(chain[b] - mvb, nb)) == sign(dot(chain[b + 2] - mvb, nb)))
        geom = (inside & same_side & seg_valid & finite).expand(chain[0].shape[:-1])[0]  # [C, R]
        ci, ri = torch.nonzero(geom, as_tuple=True)
        if ci.numel() == 0:
            continue
        pts = torch.stack([p[0][ci, ri] for p in chain], dim=-2)  # [A, k + 2, 3]
        o = pts[:, :-1, :]
        dd = pts[:, 1:, :] - pts[:, :-1, :]
        o = o + dd * HIT_TOL
        thr = torch.full(o.shape[:-1], 1.0 - 2.0 * HIT_TOL, dtype=dtype, device=tx.device)
        hit = blocked(city, o.reshape(-1, 3), dd.reshape(-1, 3), thr.reshape(-1)).reshape(o.shape[:-1])
        keep = ~hit.any(dim=-1)
        found[0].append(ri[keep])
        found[1].append(ci[keep] + c0)
        found[2].append(pts[keep])
    if not found[0]:
        empty = torch.zeros(0, dtype=torch.int64, device=tx.device)
        return empty, empty, torch.zeros((0, k + 2, 3), dtype=dtype, device=tx.device)
    return tuple(torch.cat(parts) for parts in found)
