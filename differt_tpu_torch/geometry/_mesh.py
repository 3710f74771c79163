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

import torch

from ._vectors import _cross, normalize, orthogonal_basis


def _on_card(device: torch.device | str | None) -> torch.device | str:
    """The constructors' device: the card unless the caller names another."""
    return torch.device("cuda") if device is None else device


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

    # -- Derived geometry -------------------------------------------------

    @property
    def triangle_vertices(self) -> torch.Tensor:
        """``[num_triangles, 3, 3]`` gathered per-triangle vertex coordinates."""
        return self.vertices[self.triangles]

    @property
    def bvh(self):
        """The kernels' acceleration structure (:class:`~differt_tpu_torch.ops._bvh.MeshBVH`).

        Built at first use, under ``torch.no_grad()``, on the mesh's device,
        and kept: it is keyed on the storage and version counter of
        :attr:`vertices`, :attr:`triangles` and :attr:`mask`, so an in-place
        edit of one of them rebuilds it. An edit that returns a new mesh
        (:meth:`translate`, ``+``, :meth:`set_mask`, ...) starts afresh.
        """
        key = tuple(
            None if x is None else (x.data_ptr(), x._version, tuple(x.shape))
            for x in (self.vertices, self.triangles, self.mask)
        )
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
        return cls(vertices=vertices, triangles=triangles)

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
        return cls(vertices=vertices, triangles=triangles, object_bounds=object_bounds)

    # -- Structure ops ----------------------------------------------------

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
            mask=mask,
        )

    def __add__(self, other: "Mesh") -> "Mesh":
        return self.append(other)

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
