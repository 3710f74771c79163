"""Triangle meshes (PyTorch port of ``differt_tpu.geometry._mesh``).

A :class:`Mesh` is a frozen dataclass of tensors; edits return new meshes
through :func:`dataclasses.replace`. Triangle indices are ``int64`` (what
PyTorch indexing takes) where the JAX package keeps ``int32``.

The constructors and loaders build on the card (``device=None`` means
``torch.device("cuda")``) unless asked for another device. Randomized
edits take a ``torch.Generator`` where the JAX package takes a key. A mesh
keeps the kernels' acceleration structure (:attr:`Mesh.bvh`), built at
first use and rebuilt when its tensors are edited in place; an edit that
returns a new mesh starts without one.
"""

import dataclasses
import warnings
from collections.abc import Callable, Iterator
from os import PathLike

import torch

from ._vectors import _cross, _dot, normalize, orthogonal_basis, rotation_matrix_along_axis


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


class _VertexSelection:
    """Out-of-place, differentiable edits of the vertices of a triangle selection (``mesh.at[selection]``).

    The selected triangles' corners resolve to vertex ids, each kept once
    (its first corner wins a scatter-min race over corner positions), so a
    vertex shared by several selected triangles takes one update: what
    makes accumulating edits such as ``add`` well defined. Values broadcast
    against ``[num_corners, 3]``; a repeated corner's value is dropped.
    Every edit returns a new mesh (without a BVH).
    """

    __slots__ = ("_mesh", "_selection")

    def __init__(self, mesh: "Mesh", selection) -> None:
        if not isinstance(selection, slice) and torch.as_tensor(selection).ndim > 1:
            shape = tuple(torch.as_tensor(selection).shape)
            msg = (
                "Triangle selections must be scalars, slices, or 1-D"
                f" arrays; got a {len(shape)}-D array of shape {shape}."
            )
            raise ValueError(msg)
        self._mesh = mesh
        self._selection = selection

    def __repr__(self) -> str:
        return f"{type(self._mesh).__name__}.at[{self._selection!r}]"

    def _corner_ids(self) -> torch.Tensor:
        """Vertex ids of the selected triangles' corners (with repeats)."""
        selection = self._selection
        if not isinstance(selection, slice):
            selection = torch.as_tensor(selection, device=self._mesh.device)
        return self._mesh.triangles[selection].reshape(-1)

    def _unique_vertex_ids(self) -> torch.Tensor:
        """:meth:`_corner_ids` with every repeat (and out-of-range id) parked at ``num_vertices``."""
        ids = self._corner_ids()
        num_vertices = self._mesh.vertices.shape[0]
        slots = torch.arange(ids.shape[0], device=ids.device)
        guarded = torch.where((ids >= 0) & (ids < num_vertices), ids, num_vertices)
        winner = torch.full((num_vertices + 1,), ids.shape[0], dtype=torch.int64, device=ids.device)
        winner = winner.scatter_reduce(0, guarded, slots, "amin")
        return torch.where(winner[guarded] == slots, guarded, num_vertices)

    def get(self) -> torch.Tensor:
        """``[num_corners, 3]``: the selected triangles' corner coordinates."""
        return self._mesh.vertices[self._corner_ids()]

    def _edited(self, update: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], values) -> "Mesh":
        vertices = self._mesh.vertices
        ids = self._unique_vertex_ids()
        keep = ids < vertices.shape[0]
        rows = ids[keep]
        if values is not None:
            values = torch.as_tensor(values, dtype=vertices.dtype, device=vertices.device)
            values = torch.broadcast_to(values, (ids.shape[0], 3))[keep]
        # The rows are unique, so a plain (differentiable) index_put writes each once.
        new_rows = update(vertices[rows], values)
        return dataclasses.replace(self._mesh, vertices=vertices.index_put((rows,), new_rows))

    def set(self, values) -> "Mesh":
        """Set the selected vertices to ``values``."""
        return self._edited(lambda _, v: v, values)

    def add(self, values) -> "Mesh":
        """Add ``values`` to the selected vertices (shared ones once)."""
        return self._edited(torch.add, values)

    def sub(self, values) -> "Mesh":
        """Subtract ``values`` from the selected vertices."""
        return self._edited(torch.sub, values)

    def mul(self, values) -> "Mesh":
        """Multiply the selected vertices by ``values``."""
        return self._edited(torch.mul, values)

    def div(self, values) -> "Mesh":
        """Divide the selected vertices by ``values``."""
        return self._edited(torch.div, values)

    def pow(self, values) -> "Mesh":
        """Raise the selected vertices to the power ``values``."""
        return self._edited(torch.pow, values)

    def min(self, values) -> "Mesh":
        """The elementwise minimum of the selected vertices and ``values``."""
        return self._edited(torch.minimum, values)

    def max(self, values) -> "Mesh":
        """The elementwise maximum of the selected vertices and ``values``."""
        return self._edited(torch.maximum, values)

    def apply(self, func: Callable[[torch.Tensor], torch.Tensor]) -> "Mesh":
        """Apply the elementwise ``func`` to the selected vertices (shared ones once)."""
        return self._edited(lambda rows, _: func(rows), None)


class _VertexUpdates:
    """The indexable entry point of :attr:`Mesh.at`."""

    __slots__ = ("_mesh",)

    def __init__(self, mesh: "Mesh") -> None:
        self._mesh = mesh

    def __getitem__(self, selection) -> _VertexSelection:
        return _VertexSelection(self._mesh, selection)

    def __repr__(self) -> str:
        return f"{type(self._mesh).__name__}.at"


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
    face_colors: torch.Tensor | None = None
    """Optional ``[num_triangles, 3]`` float32 RGB colour of each face (not part of the geometry)."""
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
    def num_active_triangles(self) -> int | torch.Tensor:
        """Number of active triangles (a 0-d tensor if :attr:`mask` is set)."""
        return self.mask.sum() if self.mask is not None else self.num_triangles

    @property
    def num_quads(self) -> int:
        """Number of quadrilaterals (needs :attr:`assume_quads`)."""
        if not self.assume_quads:
            msg = "num_quads is only defined when 'assume_quads' is enabled."
            raise ValueError(msg)
        return self.num_triangles // 2

    @property
    def num_active_quads(self) -> int | torch.Tensor:
        """Number of active quads (a 0-d tensor if :attr:`mask` is set)."""
        if not self.assume_quads:
            msg = "num_active_quads is only defined when 'assume_quads' is enabled."
            raise ValueError(msg)
        return self.mask[::2].sum() if self.mask is not None else self.num_quads

    @property
    def num_primitives(self) -> int:
        """Quads if :attr:`assume_quads` else triangles."""
        return self.num_quads if self.assume_quads else self.num_triangles

    @property
    def num_active_primitives(self) -> int | torch.Tensor:
        """Active quads if :attr:`assume_quads` else active triangles."""
        return self.num_active_quads if self.assume_quads else self.num_active_triangles

    @property
    def num_objects(self) -> int:
        """Number of sub-objects (1 if no :attr:`object_bounds`)."""
        return self.object_bounds.shape[0] if self.object_bounds is not None else 1

    @property
    def is_empty(self) -> bool:
        """Whether this mesh has no triangle."""
        return self.triangles.numel() == 0

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

    def set_face_colors(self, colors=None, *, generator: torch.Generator | None = None) -> "Mesh":
        """A copy with face colours: ``colors`` (``[3]`` or ``[num_triangles, 3]``), or random ones from ``generator``.

        Random colours are drawn once per object (one for the whole mesh
        without :attr:`object_bounds`), on the generator's device.

        >>> box = Mesh.box(device="cpu").set_face_colors([1.0, 0.0, 0.0])
        >>> box.face_colors.shape, box.face_colors[0].tolist()
        (torch.Size([10, 3]), [1.0, 0.0, 0.0])
        """
        if (colors is None) == (generator is None):
            msg = "You must specify one of 'colors' or 'generator', not both."
            raise ValueError(msg)
        if generator is not None:
            draw = lambda n: torch.rand((n, 3), generator=generator, device=generator.device).to(self.device)  # noqa: E731
            if self.object_bounds is not None:
                counts = self.object_bounds[:, 1] - self.object_bounds[:, 0]
                colors = torch.repeat_interleave(draw(self.object_bounds.shape[0]), counts, dim=0)
            else:
                colors = draw(1)
        colors = torch.as_tensor(colors, dtype=torch.float32, device=self.device)
        return dataclasses.replace(
            self, face_colors=torch.broadcast_to(colors, (self.num_triangles, 3)).clone()
        )

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

    def rotate(self, rotation_matrix) -> "Mesh":
        """Rotate every vertex by a ``[3, 3]`` matrix."""
        rotation_matrix = torch.as_tensor(rotation_matrix, dtype=self.vertices.dtype, device=self.device)
        return dataclasses.replace(self, vertices=(rotation_matrix @ self.vertices.T).T)

    def scale(self, scale_factor) -> "Mesh":
        """Scale every vertex by a scalar factor."""
        return dataclasses.replace(self, vertices=self.vertices * scale_factor)

    def translate(self, translation) -> "Mesh":
        """Translate every vertex."""
        translation = torch.as_tensor(
            translation, dtype=self.vertices.dtype, device=self.device
        )
        return dataclasses.replace(self, vertices=self.vertices + translation)

    def center(self) -> tuple["Mesh", torch.Tensor]:
        """The mesh moved so that its bounding box is centred at the origin, and the translation applied.

        >>> mesh, offset = Mesh.box(device="cpu").translate([1.0, 2.0, 3.0]).center()
        >>> offset.tolist(), mesh.bounding_box.mean(dim=0).tolist()
        ([-1.0, -2.0, -3.0], [0.0, 0.0, 0.0])
        """
        offset = self.bounding_box.mean(dim=0)
        return self.translate(-offset), -offset

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
        vertex_b=None,
        vertex_c=None,
        *,
        normal=None,
        side_length: float = 1.0,
        rotate=None,
        device: torch.device | str | None = None,
    ) -> "Mesh":
        """Square plane (two triangles) centred at ``vertex_a``.

        Its orientation comes from two more in-plane vertices
        (``vertex_b``, ``vertex_c``) or from a unit ``normal``; ``rotate``
        turns it by that angle (rad) about its normal. Quad-compatible.

        >>> [x + 0.0 for x in Mesh.plane([0.0, 0, 0], [1.0, 0, 0], [0.0, 1, 0], device="cpu").normals[0].tolist()]
        [0.0, 0.0, 1.0]
        """
        if (vertex_b is None) != (vertex_c is None):
            msg = "You must specify either of both of 'vertex_b' and 'vertex_c', or none."
            raise ValueError(msg)
        if (vertex_b is None) == (normal is None):
            msg = (
                "A plane is defined either by two extra vertices or by a"
                " normal; pass ('vertex_b', 'vertex_c') or 'normal', not both."
            )
            raise ValueError(msg)
        device = _on_card(device)
        as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
        vertex_a = as_f32(vertex_a)
        if vertex_b is not None:
            normal = normalize(_cross(as_f32(vertex_b) - vertex_a, as_f32(vertex_c) - vertex_a))[0]
        else:
            normal = as_f32(normal)
        u, v = orthogonal_basis(normal)
        s = 0.5 * side_length
        vertices = s * torch.stack((u + v, v - u, -u - v, u - v))
        if rotate is not None:
            vertices = (rotation_matrix_along_axis(as_f32(rotate), normal) @ vertices.T).T
        vertices = vertices + vertex_a
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

    @classmethod
    def load_obj(cls, file: str | PathLike[str], *, device: torch.device | str | None = None) -> "Mesh":
        """Load a Wavefront .obj file (vertices, triangles, MTL colours and materials); see :func:`differt_tpu_torch.io.load_obj`."""
        from ..io import load_obj

        return load_obj(file, device=device)

    @classmethod
    def load_ply(cls, file: str | PathLike[str], *, device: torch.device | str | None = None) -> "Mesh":
        """Load a Stanford .ply file (ascii or binary, either endianness); see :func:`differt_tpu_torch.io.load_ply`."""
        from ..io import load_ply

        return load_ply(file, device=device)

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
            face_colors=None if self.face_colors is None else self.face_colors[key],
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
        (black colours, -1 materials, all-active masks); a bound-less
        non-empty side counts as one object.
        """
        num_self, num_other = self.num_triangles, other.num_triangles
        device = self.device
        vertices = torch.cat((self.vertices, other.vertices))
        triangles = torch.cat(
            (self.triangles, other.triangles + self.vertices.shape[0])
        )

        face_colors = None
        if self.face_colors is not None or other.face_colors is not None:
            black = lambda n: torch.zeros((n, 3), device=device)  # noqa: E731
            face_colors = torch.cat((
                self.face_colors if self.face_colors is not None else black(num_self),
                other.face_colors if other.face_colors is not None else black(num_other),
            ))

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
            face_colors=face_colors,
            face_materials=face_materials,
            material_names=tuple(material_names),
            object_bounds=object_bounds,
            assume_quads=self.assume_quads and other.assume_quads,
            assume_unique_vertices=False,
            mask=mask,
        )

    def __add__(self, other: "Mesh") -> "Mesh":
        return self.append(other)

    # -- Sampling, clipping and vertex edits ------------------------------

    def sample(
        self,
        size: int,
        replace: bool = False,
        preserve: bool = False,
        *,
        by_masking: bool = False,
        generator: torch.Generator | None = None,
    ) -> "Mesh":
        """``size`` triangles drawn at random (from ``generator``), by index or, with ``by_masking``, as a mask.

        ``by_masking`` keeps every triangle and sets :attr:`mask` (fixed
        shapes); with ``preserve`` the draw is also limited to the active
        triangles of the current mask.

        >>> box = Mesh.box(device="cpu")
        >>> box.sample(4, generator=torch.Generator().manual_seed(0)).num_triangles
        4
        """
        num = self.num_triangles
        device = self.device if generator is None else generator.device
        if by_masking:
            if replace:
                idx = torch.randint(0, num, (size,), generator=generator, device=device).to(self.device)
                mask = torch.zeros(num, dtype=torch.bool, device=self.device)
                mask[idx] = True
            else:
                scores = torch.rand(num, generator=generator, device=device).to(self.device)
                threshold = torch.sort(scores, descending=True).values[size - 1] if size > 0 else torch.inf
                mask = scores >= threshold
            if preserve and self.mask is not None:
                mask = mask & self.mask
            return self.set_mask(mask)
        if replace:
            idx = torch.randint(0, num, (size,), generator=generator, device=device)
        else:
            if size > num:
                msg = f"Cannot take {size} triangles of {num} without replacement."
                raise ValueError(msg)
            idx = torch.randperm(num, generator=generator, device=device)[:size]
        return self[idx.to(self.device)]

    def shuffle(self, *, generator: torch.Generator | None = None) -> "Mesh":
        """The triangles in a random order (from ``generator``); object bounds dropped."""
        device = self.device if generator is None else generator.device
        return self[torch.randperm(self.num_triangles, generator=generator, device=device).to(self.device)]

    def clip(self, x_min=None, x_max=None, y_min=None, y_max=None, z_min=None, z_max=None) -> "Mesh":
        """Mask out the triangles whose centroid lies outside the given limits (and the already inactive ones).

        >>> Mesh.box(device="cpu").clip(z_max=-0.4).num_active_triangles.item()
        2
        """
        centers = self.triangle_vertices.mean(dim=-2)
        keep = torch.ones(self.num_triangles, dtype=torch.bool, device=self.device)
        for axis, (lo, hi) in enumerate(((x_min, x_max), (y_min, y_max), (z_min, z_max))):
            if lo is not None:
                keep &= centers[:, axis] >= lo
            if hi is not None:
                keep &= centers[:, axis] <= hi
        if self.mask is not None:
            keep &= self.mask
        return self.set_mask(keep)

    def _inside(self, bounding_box) -> torch.Tensor:
        """``[num_triangles, 3]`` bool: which corners lie inside the ``[2, 3]`` box."""
        box = torch.as_tensor(bounding_box, dtype=self.vertices.dtype, device=self.device)
        tv = self.triangle_vertices
        return ((tv >= box[0]) & (tv <= box[1])).all(dim=-1)

    def keep_all_within(self, bounding_box) -> "Mesh":
        """Mask keeping the (active) triangles whose every corner lies inside the ``[2, 3]`` box."""
        keep = self._inside(bounding_box).all(dim=-1)
        return self.set_mask(keep & self.mask if self.mask is not None else keep)

    def keep_any_within(self, bounding_box) -> "Mesh":
        """Mask keeping the (active) triangles with at least one corner inside the ``[2, 3]`` box."""
        keep = self._inside(bounding_box).any(dim=-1)
        return self.set_mask(keep & self.mask if self.mask is not None else keep)

    def add_ground(self, side_length=None, *, elevation=0.0) -> "Mesh":
        """Append a horizontal square ground plane under the mesh's centre, at ``elevation``.

        Its side is twice the larger horizontal extent unless given.

        >>> Mesh.box(device="cpu").add_ground().num_triangles
        12
        """
        bbox = self.bounding_box
        center = bbox.mean(dim=0)
        if side_length is None:
            side_length = 2.0 * (bbox[1, :2] - bbox[0, :2]).max()
        up = torch.tensor([0.0, 0.0, 1.0], device=self.device)
        origin = torch.stack((center[0], center[1], torch.zeros_like(center[0])))
        ground = Mesh.plane(origin + up * elevation, normal=up, side_length=side_length, device=self.device)
        return self.append(ground)

    @property
    def at(self) -> _VertexUpdates:
        """Differentiable vertex edits of a triangle selection: ``mesh.at[index].add(delta)``, ...

        Each vertex of the selection is edited once, however many of the
        selected triangles share it (:class:`_VertexSelection`).

        >>> box = Mesh.box(device="cpu")
        >>> moved = box.at[0].add(torch.tensor([0.0, 0.0, 1.0]))
        >>> int((moved.vertices != box.vertices).any(dim=-1).sum())
        3
        """
        return _VertexUpdates(self)

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

    def plot(self, **kwargs):
        """Draw the mesh (:func:`differt_tpu_torch.plotting.draw_mesh`)."""
        from ..plotting import draw_mesh

        return draw_mesh(self, **kwargs)
