"""Triangle meshes (PyTorch port of ``differt_tpu.geometry._mesh``, main-path subset).

A :class:`Mesh` is a frozen dataclass of tensors; edits return new meshes
through :func:`dataclasses.replace`. Triangle indices are ``int64`` (what
PyTorch indexing takes) where the JAX package keeps ``int32``.

The constructors build on the card (``device=None`` means
``torch.device("cuda")``) unless asked for another device. A mesh keeps
the kernels' acceleration structure (:attr:`Mesh.bvh`), built at first use
and rebuilt when its tensors are edited in place.
"""

import dataclasses
import warnings
from collections.abc import Iterator

import torch

from ._vectors import _cross, _dot, normalize, orthogonal_basis


def _on_card(device: torch.device | str | None) -> torch.device | str:
    """The constructors' device: the card unless the caller names another."""
    return torch.device("cuda") if device is None else device


def _warn_non_manifold_edges(count: int) -> None:
    """The warning of :meth:`Mesh._connectivity`, issued only when ``count`` is not 0."""
    if count:
        warnings.warn(
            f"Mesh contains {count} non-manifold edge(s): more than two"
            " faces share the same pair of vertices. These edges are"
            " excluded from diffraction-edge extraction.",
            UserWarning,
            stacklevel=3,
        )


def _first_occurrences(inverse: torch.Tensor, num_unique: int) -> torch.Tensor:
    """The first position of each of ``num_unique`` groups (``return_index`` of ``jnp.unique``)."""
    positions = torch.arange(inverse.shape[0], device=inverse.device)
    first = torch.full((num_unique,), inverse.shape[0], dtype=torch.int64, device=inverse.device)
    return first.scatter_reduce_(0, inverse, positions, "amin")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A triangle mesh with optional materials, sub-objects and active mask.

    >>> Mesh.box(2.0, 3.0, 4.0, with_top=True, device="cpu").num_triangles
    12
    """

    vertices: torch.Tensor
    """``[num_vertices, 3]`` float32 vertex coordinates."""
    triangles: torch.Tensor
    """``[num_triangles, 3]`` int64 vertex indices."""
    face_materials: torch.Tensor | None = None
    """Optional ``[num_triangles]`` material indices into :attr:`material_names` (-1 = unset)."""
    material_names: tuple[str, ...] = ()
    """Unique material names."""
    object_bounds: torch.Tensor | None = None
    """Optional ``[num_objects, 2]`` start/end triangle indices of each sub-object."""
    assume_quads: bool = False
    """If set, each two consecutive triangles form a quadrilateral primitive."""
    assume_unique_vertices: bool = False
    """If set, vertices are taken as deduplicated (the edges' connectivity relies on it)."""
    mask: torch.Tensor | None = None
    """Optional ``[num_triangles]`` bool active-triangle mask."""
    _bvh: tuple | None = dataclasses.field(default=None, init=False, repr=False, compare=False)
    """The cached ``(key, MeshBVH)`` of :attr:`bvh`; a new mesh starts without one."""

    def __post_init__(self) -> None:
        if self.assume_quads and self.triangles.shape[0] % 2 != 0:
            msg = (
                "'assume_quads' needs an even triangle count (each quad is a"
                f" triangle pair), but this mesh has {self.triangles.shape[0]}."
            )
            raise ValueError(msg)
        if len(set(self.material_names)) != len(self.material_names):
            msg = f"Duplicate entries in material_names: {self.material_names!r}."
            raise ValueError(msg)

    # -- Sizes ------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @property
    def num_triangles(self) -> int:
        """Triangle count (including masked-out ones)."""
        return self.triangles.shape[0]

    @property
    def num_primitives(self) -> int:
        """Quads if :attr:`assume_quads` else triangles."""
        return self.num_triangles // 2 if self.assume_quads else self.num_triangles

    @property
    def num_objects(self) -> int:
        """Number of sub-objects (1 if no :attr:`object_bounds`)."""
        return self.object_bounds.shape[0] if self.object_bounds is not None else 1

    # -- Derived geometry -------------------------------------------------

    @property
    def triangle_vertices(self) -> torch.Tensor:
        """``[num_triangles, 3, 3]`` gathered per-triangle vertex coordinates."""
        return self.vertices[self.triangles]

    @property
    def triangle_edges(self) -> torch.Tensor:
        """``[num_triangles, 3, 2, 3]`` per-triangle edges as (start, end) vertex pairs.

        Edge ``e`` runs from corner ``e`` to corner ``e - 1``.
        """
        tv = self.triangle_vertices
        return torch.stack((tv, torch.roll(tv, 1, dims=-2)), dim=-2)

    def _bvh_key(self) -> tuple:
        return tuple(
            None if x is None else (x.data_ptr(), x._version, tuple(x.shape))
            for x in (self.vertices, self.triangles, self.mask)
        )

    @property
    def bvh(self):
        """The kernels' acceleration structure (:class:`~differt_tpu_torch.ops._bvh.MeshBVH`).

        Built at first use, under ``torch.no_grad()``, on the mesh's device,
        and kept: it is keyed on the storage and version counter of
        :attr:`vertices`, :attr:`triangles` and :attr:`mask`, so an in-place
        edit of one of them rebuilds it. An edit that returns a new mesh
        (:meth:`translate`, ``+``, :meth:`set_mask`, ...) starts afresh.
        """
        key = self._bvh_key()
        if self._bvh is None or self._bvh[0] != key:
            from ..ops._bvh import build_bvh

            with torch.no_grad():
                bvh = build_bvh(self.triangle_vertices, self.mask)
            object.__setattr__(self, "_bvh", (key, bvh))
        return self._bvh[1]

    @property
    def normals(self) -> torch.Tensor:
        """``[num_triangles, 3]`` unit triangle normals."""
        tv = self.triangle_vertices
        edges = tv[:, 1:, :] - tv[:, :-1, :]
        return normalize(_cross(edges[:, 0, :], edges[:, 1, :]))[0]

    @property
    def bounding_box(self) -> torch.Tensor:
        """``[2, 3]`` axis-aligned bounding box (min and max corners)."""
        return torch.stack(
            (self.vertices.min(dim=0).values, self.vertices.max(dim=0).values)
        )

    # -- Setters ----------------------------------------------------------

    def set_assume_quads(self, flag: bool = True) -> "Mesh":
        return dataclasses.replace(self, assume_quads=flag)

    def set_assume_unique_vertices(self, flag: bool = True) -> "Mesh":
        return dataclasses.replace(self, assume_unique_vertices=flag)

    def set_mask(self, mask: torch.Tensor | None) -> "Mesh":
        return dataclasses.replace(self, mask=mask)

    def set_materials(self, *names: str) -> "Mesh":
        """Register material names; assign the single material to all faces if one."""
        mesh = dataclasses.replace(self, material_names=tuple(names))
        if len(names) == 1:
            mesh = mesh.set_face_materials(0)
        return mesh

    def set_face_materials(self, materials: int | torch.Tensor) -> "Mesh":
        materials = torch.as_tensor(materials, dtype=torch.int64, device=self.device)
        return dataclasses.replace(
            self, face_materials=materials.expand(self.num_triangles).clone()
        )

    def translate(self, translation) -> "Mesh":
        translation = torch.as_tensor(
            translation, dtype=self.vertices.dtype, device=self.device
        )
        return dataclasses.replace(self, vertices=self.vertices + translation)

    # -- Constructors -----------------------------------------------------

    @classmethod
    def empty(cls, *, device: torch.device | str | None = None) -> "Mesh":
        device = _on_card(device)
        return cls(
            vertices=torch.empty((0, 3), device=device),
            triangles=torch.empty((0, 3), dtype=torch.int64, device=device),
        )

    @classmethod
    def plane(
        cls,
        vertex_a,
        *,
        normal,
        side_length: float = 1.0,
        device: torch.device | str | None = None,
    ) -> "Mesh":
        """Square plane (two triangles) centered at ``vertex_a`` with unit ``normal``."""
        device = _on_card(device)
        vertex_a = torch.as_tensor(vertex_a, dtype=torch.float32, device=device)
        normal = torch.as_tensor(normal, dtype=torch.float32, device=device)
        u, v = orthogonal_basis(normal)
        s = 0.5 * side_length
        vertices = s * torch.stack((u + v, v - u, -u - v, u - v)) + vertex_a
        triangles = torch.tensor([[0, 1, 2], [0, 2, 3]], device=device)
        return cls(vertices=vertices, triangles=triangles, assume_unique_vertices=True)

    @classmethod
    def box(
        cls,
        length: float = 1.0,
        width: float = 1.0,
        height: float = 1.0,
        *,
        with_top: bool = False,
        with_bottom: bool = True,
        device: torch.device | str | None = None,
    ) -> "Mesh":
        """Axis-aligned box, optionally open at top/bottom (quad-compatible).

        Same vertex and triangle order as the JAX package, so object
        bounds and normals match.
        """
        device = _on_card(device)
        dx = torch.tensor([length * 0.5, 0.0, 0.0], device=device)
        dy = torch.tensor([0.0, width * 0.5, 0.0], device=device)
        dz = torch.tensor([0.0, 0.0, height * 0.5], device=device)
        vertices = torch.stack((
            +dx + dy + dz,
            +dx + dy - dz,
            -dx + dy - dz,
            -dx + dy + dz,
            -dx - dy - dz,
            -dx - dy + dz,
            +dx - dy - dz,
            +dx - dy + dz,
        ))
        triangles = [
            [0, 1, 2],
            [0, 2, 3],
            [3, 2, 4],
            [3, 4, 5],
            [5, 4, 6],
            [5, 6, 7],
            [7, 6, 1],
            [7, 1, 0],
        ]
        if with_bottom:
            triangles += [[1, 4, 2], [1, 6, 4]]
        if with_top:
            triangles += [[0, 3, 5], [0, 5, 7]]
        triangles = torch.tensor(triangles, device=device)
        edges = torch.arange(0, triangles.shape[0] + 1, 2, device=device)
        object_bounds = torch.stack((edges[:-1], edges[1:]), dim=-1)
        return cls(
            vertices=vertices,
            triangles=triangles,
            object_bounds=object_bounds,
            assume_unique_vertices=True,
        )

    # -- Structure ops ----------------------------------------------------

    def __getitem__(self, key) -> "Mesh":
        """The triangles that ``key`` (a slice, indices or a bool mask) selects; object bounds dropped.

        >>> box = Mesh.box(with_top=True, device="cpu")
        >>> box[2:6].num_triangles, box[2:6].num_objects
        (4, 1)
        """
        return Mesh(
            vertices=self.vertices,
            triangles=self.triangles[key],
            face_materials=None if self.face_materials is None else self.face_materials[key],
            material_names=self.material_names,
            assume_unique_vertices=self.assume_unique_vertices,
            mask=None if self.mask is None else self.mask[key],
        )

    def iter_objects(self) -> Iterator["Mesh"]:
        """Each sub-object as a mesh (the whole mesh if there are no :attr:`object_bounds`)."""
        if self.object_bounds is None:
            yield self
            return
        for start, end in self.object_bounds.tolist():
            yield self[start:end].set_assume_quads(self.assume_quads and (end - start) % 2 == 0)

    def dedup_vertices(self, num_decimals: int | None = None) -> "Mesh":
        """Merge equal vertices (rounded to ``num_decimals`` first, if given) and re-index.

        The unique vertices come in lexicographic order, each the first of
        its equals (-0.0 equals 0.0), as ``jnp.unique`` gives them. Without
        rounding, every triangle keeps corners equal to its old ones, in
        the same order: the mesh's current :attr:`bvh` then serves the new
        mesh too.

        >>> box = Mesh.box(device="cpu")
        >>> (box + box).dedup_vertices().vertices.shape
        torch.Size([8, 3])
        """
        keys = self.vertices if num_decimals is None else torch.round(self.vertices, decimals=num_decimals)
        # Adding 0.0 turns -0.0 into 0.0, so that every sort sees one zero.
        _, inverse = torch.unique(keys + 0.0, dim=0, return_inverse=True)
        num_unique = int(inverse.max()) + 1 if inverse.numel() else 0
        index = _first_occurrences(inverse, num_unique)
        mesh = dataclasses.replace(
            self,
            vertices=self.vertices[index],
            triangles=inverse[self.triangles],
            assume_unique_vertices=True,
        )
        if num_decimals is None and self._bvh is not None and self._bvh[0] == self._bvh_key():
            object.__setattr__(mesh, "_bvh", (mesh._bvh_key(), self._bvh[1]))
        return mesh

    def drop_unused_vertices(self) -> "Mesh":
        """Remove the vertices that no triangle uses."""
        used = torch.zeros(self.vertices.shape[0], dtype=torch.bool, device=self.device)
        used[self.triangles.reshape(-1)] = True
        new_index = torch.cumsum(used, dim=0) - 1
        return dataclasses.replace(
            self, vertices=self.vertices[used], triangles=new_index[self.triangles]
        )

    def drop_duplicates(self) -> "Mesh":
        """Remove repeated triangles (the same set of vertex indices), keeping each first one."""
        rows = torch.sort(self.triangles, dim=-1).values
        _, inverse = torch.unique(rows, dim=0, return_inverse=True)
        num_unique = int(inverse.max()) + 1 if inverse.numel() else 0
        return self[torch.sort(_first_occurrences(inverse, num_unique)).values]

    def masked(self) -> "Mesh":
        """The active triangles only, with no :attr:`mask`."""
        if self.mask is None:
            return self
        return self[self.mask].set_mask(None)

    def append(self, other: "Mesh") -> "Mesh":
        """Concatenate two meshes (vertices re-indexed, materials merged by name).

        Optional fields present on one side only get defaults on the other
        (-1 materials, all-active masks); a bound-less non-empty side counts
        as one object.
        """
        num_self, num_other = self.num_triangles, other.num_triangles
        device = self.device
        vertices = torch.cat((self.vertices, other.vertices))
        triangles = torch.cat(
            (self.triangles, other.triangles + self.vertices.shape[0])
        )

        material_names = list(self.material_names)
        remap = []
        for name in other.material_names:
            if name not in material_names:
                material_names.append(name)
            remap.append(material_names.index(name))

        face_materials = None
        if self.face_materials is not None or other.face_materials is not None:
            self_mats = (
                self.face_materials
                if self.face_materials is not None
                else torch.full((num_self,), -1, dtype=torch.int64, device=device)
            )
            other_mats = (
                other.face_materials
                if other.face_materials is not None
                else torch.full((num_other,), -1, dtype=torch.int64, device=device)
            )
            if remap:
                lut = torch.tensor(remap, dtype=torch.int64, device=device)
                other_mats = torch.where(
                    other_mats >= 0, lut[other_mats.clamp(min=0)], other_mats
                )
            face_materials = torch.cat((self_mats, other_mats))

        segments = []
        if self.object_bounds is not None:
            segments.append(self.object_bounds)
        elif num_self > 0:
            segments.append(torch.tensor([[0, num_self]], device=device))
        if other.object_bounds is not None:
            segments.append(other.object_bounds + num_self)
        elif num_other > 0:
            segments.append(torch.tensor([[num_self, num_self + num_other]], device=device))
        object_bounds = torch.cat(segments) if segments else None

        mask = None
        if self.mask is not None or other.mask is not None:
            ones = lambda n: torch.ones(n, dtype=torch.bool, device=device)  # noqa: E731
            mask = torch.cat((
                self.mask if self.mask is not None else ones(num_self),
                other.mask if other.mask is not None else ones(num_other),
            ))

        return Mesh(
            vertices=vertices,
            triangles=triangles,
            face_materials=face_materials,
            material_names=tuple(material_names),
            object_bounds=object_bounds,
            assume_quads=self.assume_quads and other.assume_quads,
            assume_unique_vertices=False,
            mask=mask,
        )

    def __add__(self, other: "Mesh") -> "Mesh":
        return self.append(other)

    # -- Diffraction edges ------------------------------------------------

    def _connectivity(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Each half-edge's neighbour: ``(triangle, local edge)``, two ``[num_triangles, 3]`` int64.

        Half-edge ``e`` of a triangle joins its corners ``e`` and ``e - 1``.
        The neighbour is -1 on a boundary edge, on a non-manifold one (more
        than two faces: counted, and warned of once with the count) and,
        with :attr:`assume_quads`, on a quad's diagonal. Edges are matched
        by vertex index, so the vertices must be unique
        (:attr:`assume_unique_vertices`).
        """
        triangles = self.triangles
        num_triangles = triangles.shape[0]
        if num_triangles == 0:
            empty = torch.empty((0, 3), dtype=torch.int64, device=self.device)
            return empty, empty

        half_edges = torch.stack(
            (triangles[:, [0, 2]], triangles[:, [1, 0]], triangles[:, [2, 1]]), dim=1
        ).reshape(-1, 2)
        undirected = torch.sort(half_edges, dim=-1).values
        n_half = undirected.shape[0]
        # The lexicographic order of (low, high) vertex pairs, stable: one key.
        keys = undirected[:, 0] * self.vertices.shape[0] + undirected[:, 1]
        order = torch.sort(keys, stable=True).indices
        sorted_keys = keys[order]

        same_as_prev = torch.cat((
            torch.zeros(1, dtype=torch.bool, device=self.device),
            sorted_keys[1:] == sorted_keys[:-1],
        ))
        group_ids = torch.cumsum(~same_as_prev, dim=0) - 1
        group_counts = torch.bincount(group_ids, minlength=n_half)
        is_manifold = group_counts[group_ids] == 2
        _warn_non_manifold_edges(int((group_counts > 2).sum()))

        positions = torch.arange(n_half, device=self.device)
        partner_sorted = torch.where(same_as_prev, positions - 1, positions + 1)
        partner = order[partner_sorted.clamp(max=n_half - 1)]
        adj = torch.full((n_half,), -1, dtype=torch.int64, device=self.device)
        adj[order] = torch.where(is_manifold, partner, -1)

        adj_t = torch.where(adj != -1, adj // 3, -1).reshape(num_triangles, 3)
        adj_e = torch.where(adj != -1, adj % 3, -1).reshape(num_triangles, 3)
        if self.assume_quads:
            # The shared diagonal inside a quad is not a geometric edge.
            t_idx = torch.arange(num_triangles, device=self.device)[:, None]
            is_diagonal = torch.where(t_idx % 2 == 0, adj_t == t_idx + 1, adj_t == t_idx - 1)
            adj_t = torch.where(is_diagonal, -1, adj_t)
            adj_e = torch.where(is_diagonal, -1, adj_e)
        return adj_t, adj_e

    def _neighbour_cosines(self, normals: torch.Tensor, adj_t: torch.Tensor) -> torch.Tensor:
        """``[num_triangles, 3]`` cosine between each face's normal and its neighbour's (0 without one)."""
        adj_safe = torch.where(adj_t != -1, adj_t, self.num_triangles)
        padded = torch.cat((normals, normals.new_zeros((1, 3))))
        return _dot(normals[:, None, :], padded[adj_safe])

    def _edges_mask(self, normals: torch.Tensor, adj_t: torch.Tensor) -> torch.Tensor:
        """:attr:`diffraction_edges_mask` from the connectivity."""
        mask = adj_t != -1
        if self.mask is not None:
            adj_safe = torch.where(adj_t != -1, adj_t, self.num_triangles)
            padded = torch.cat((self.mask, self.mask.new_zeros(1)))
            mask = mask & self.mask[:, None] & padded[adj_safe]
        cos_phi = self._neighbour_cosines(normals, adj_t)
        coplanar = cos_phi > 1.0 - 10.0 * torch.finfo(cos_phi.dtype).eps
        return mask & ~coplanar

    def _wedge_angles(
        self, normals: torch.Tensor, adj_t: torch.Tensor, adj_e: torch.Tensor, mask: torch.Tensor
    ) -> torch.Tensor:
        """:attr:`wedge_angles` from the connectivity and the edges' mask."""
        phi = torch.arccos(self._neighbour_cosines(normals, adj_t).clamp(-1.0, 1.0))
        # Side test: where does the neighbour's corner opposite the shared
        # edge lie relative to this face's plane? Above (+normal) means a
        # reflex wedge, below a convex one.
        vertices = self.triangle_vertices
        opposite_of_edge = torch.tensor([1, 2, 0], device=self.device)
        opp_idx = opposite_of_edge[torch.where(adj_e != -1, adj_e, 0)]
        adj_safe = torch.where(adj_t != -1, adj_t, self.num_triangles)
        padded = torch.cat((vertices, vertices.new_zeros((1, 3, 3))))
        to_opposite = padded[adj_safe, opp_idx] - vertices
        side = torch.sign(_dot(normals[:, None, :], to_opposite))
        n = 1.0 - side * phi / torch.pi
        return torch.where(mask, n, 1.0)

    @property
    def diffraction_edges_mask(self) -> torch.Tensor:
        """``[num_triangles, 3]`` bool: which half-edges diffract.

        A half-edge diffracts when it is manifold (exactly two faces), both
        faces are active and they are not coplanar. Vertices are
        deduplicated first unless :attr:`assume_unique_vertices`.

        >>> Mesh.box(with_top=True, device="cpu").diffraction_edges_mask.sum().item()
        24
        """
        if not self.assume_unique_vertices:
            return self.dedup_vertices().diffraction_edges_mask
        if self.num_triangles == 0:
            return torch.empty((0, 3), dtype=torch.bool, device=self.device)
        adj_t, _ = self._connectivity()
        return self._edges_mask(self.normals, adj_t)

    @property
    def wedge_angles(self) -> torch.Tensor:
        """``[num_triangles, 3]`` wedge parameter ``n`` per half-edge (exterior angle ``n * pi``).

        Convex wedges (the neighbour bends away from the normal) have
        ``n > 1``, reflex ones ``n < 1``; half-edges that do not diffract
        report 1.
        """
        if not self.assume_unique_vertices:
            return self.dedup_vertices().wedge_angles
        if self.num_triangles == 0:
            return torch.empty((0, 3), device=self.device)
        normals = self.normals
        adj_t, adj_e = self._connectivity()
        return self._wedge_angles(normals, adj_t, adj_e, self._edges_mask(normals, adj_t))

    def _diffraction_edges_info(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The unique diffraction edges: ``[E, 2, 3]`` coordinates, ``[E, 2]`` int64 adjacent triangles, ``[E]`` wedge ``n``.

        Edges come in the lexicographic order of their (low, high) vertex
        indices, each as the first of its half-edges (in triangle, then
        edge order) runs; its triangle is the first adjacent one. The
        vertices must be unique (:attr:`assume_unique_vertices`).
        """
        device = self.device
        if self.num_triangles == 0:
            mask = torch.empty((0, 3), dtype=torch.bool, device=device)
        else:
            normals = self.normals
            adj_t, adj_e = self._connectivity()
            mask = self._edges_mask(normals, adj_t)
        t_idx, e_idx = torch.nonzero(mask, as_tuple=True)
        if t_idx.shape[0] == 0:
            return (
                torch.empty((0, 2, 3), device=device),
                torch.empty((0, 2), dtype=torch.int64, device=device),
                torch.empty((0,), device=device),
            )

        v_start = self.triangles[t_idx, e_idx]
        v_end = self.triangles[t_idx, (e_idx - 1) % 3]
        keys = torch.minimum(v_start, v_end) * self.vertices.shape[0] + torch.maximum(v_start, v_end)
        unique_keys, inverse = torch.unique(keys, return_inverse=True)
        num_edges = unique_keys.shape[0]
        unique_idx = _first_occurrences(inverse, num_edges)

        flat_half = t_idx * 3 + e_idx
        edges = self.triangle_edges.reshape(-1, 2, 3)[flat_half[unique_idx]]

        sort_idx = torch.sort(inverse, stable=True).indices
        sorted_inverse = inverse[sort_idx]
        sorted_t = t_idx[sort_idx]
        is_second = torch.cat((
            torch.zeros(1, dtype=torch.bool, device=device),
            sorted_inverse[1:] == sorted_inverse[:-1],
        ))
        adjacent = torch.full((num_edges, 2), -1, dtype=torch.int64, device=device)
        adjacent[sorted_inverse[~is_second], 0] = sorted_t[~is_second]
        adjacent[sorted_inverse[is_second], 1] = sorted_t[is_second]

        wedge_n = self._wedge_angles(normals, adj_t, adj_e, mask)[t_idx[unique_idx], e_idx[unique_idx]]
        return edges, adjacent, wedge_n

    @property
    def diffraction_edges(self) -> torch.Tensor:
        """``[num_edges, 2, 3]`` start and end of each unique diffraction edge.

        >>> Mesh.box(with_top=True, device="cpu").diffraction_edges.shape
        torch.Size([12, 2, 3])
        """
        if not self.assume_unique_vertices:
            return self.dedup_vertices().diffraction_edges
        return self._diffraction_edges_info()[0]

    @property
    def diffraction_edges_to_triangles(self) -> torch.Tensor:
        """``[num_edges, 2]`` int64 adjacent triangles of each diffraction edge (-1 if single-sided)."""
        if not self.assume_unique_vertices:
            return self.dedup_vertices().diffraction_edges_to_triangles
        return self._diffraction_edges_info()[1]

    @property
    def wedge_parameters(self) -> torch.Tensor:
        """``[num_edges]`` wedge parameter ``n`` of each unique diffraction edge."""
        if not self.assume_unique_vertices:
            return self.dedup_vertices().wedge_parameters
        return self._diffraction_edges_info()[2]

    # -- Ray casting ------------------------------------------------------

    def ray_intersect_any_triangle(
        self,
        ray_origins: torch.Tensor,
        ray_directions: torch.Tensor,
        **kwargs,
    ) -> torch.Tensor:
        """Occlusion test against all (active) mesh triangles.

        On CUDA tensors it runs the hand-written any-hit kernel; on CPU
        tensors its plain PyTorch version (see :mod:`..ops._dispatch`).
        """
        from ..ops import dispatch_ray_intersect_any_triangle

        return dispatch_ray_intersect_any_triangle(
            self, ray_origins, ray_directions, **kwargs
        )

    def first_triangle_hit_by_ray(
        self,
        ray_origins: torch.Tensor,
        ray_directions: torch.Tensor,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Closest-hit query: ``(index, t)`` of the first active triangle hit, or ``(-1, inf)``.

        The index (int64) carries no gradient; ``t`` is differentiable with
        respect to :attr:`vertices` and the rays (the backward recomputes it
        from the frozen hit triangle). On CUDA tensors it runs the
        hand-written closest-hit kernel; on CPU tensors its plain PyTorch
        version (see :mod:`..ops._dispatch`).

        >>> import torch
        >>> box = Mesh.box(with_top=True, device="cpu")
        >>> index, t = box.first_triangle_hit_by_ray(torch.zeros(3), torch.tensor([1.0, 0, 0]))
        >>> float(t)
        0.5
        """
        from ..ops import dispatch_first_triangle_hit_by_ray

        return dispatch_first_triangle_hit_by_ray(self, ray_origins, ray_directions)

    def triangles_visible_from_vertex(
        self, vertex: torch.Tensor, num_rays: int = int(1e6), **kwargs
    ) -> torch.Tensor:
        """Which (active) triangles each ``[*batch, 3]`` vertex sees, ``[*batch, num_triangles]`` bool.

        Estimated by launching ``num_rays`` lattice rays over each vertex's
        frustum and marking the first triangle each ray hits: through the
        closest-hit kernel on CUDA tensors, its plain version on CPU tensors
        (see :mod:`..ops._dispatch`; ``kwargs``: ``batch_size``, ``epsilon``).

        >>> import torch
        >>> box = Mesh.box(10.0, 10.0, 10.0, with_top=True, device="cpu")
        >>> box.triangles_visible_from_vertex(torch.tensor([0.0, 0.0, 20.0]), num_rays=2000).tolist()
        [False, False, False, False, False, False, False, False, False, False, True, True]
        """
        from ..ops import dispatch_triangles_visible_from_vertex

        return dispatch_triangles_visible_from_vertex(self, vertex, num_rays=num_rays, **kwargs)
