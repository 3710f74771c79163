"""Differentiable coverage maps (PyTorch port of ``differt_tpu.coverage``).

Trace the specular paths, run the slab-Fresnel Jones chain on them, and sum
the complex channel amplitudes per TX/RX pixel. :func:`power_map_chunked`
streams candidates and receivers through fixed-size tiles, so memory stays
``O(candidate_chunk * rx_chunk)`` at city scale. Gradients flow from the map
to the transmitters, the materials and the mesh's vertices; with a
``smoothing_factor`` each path is weighted by its float confidence, and
they flow through path validity too.
"""

import copy
import dataclasses
import math
from collections.abc import Iterator
from typing import Any

import torch

from .em import c, epsilon_0, materials, z_0
from .em._fresnel import slab_reflection_coefficients
from .geometry import Scene, TracedPaths
from .profiling import annotate
from .utils import dot3, gather_columns, normalize3, safe_divide, sp_directions3, spherical3


def complex_amplitudes(
    paths: TracedPaths,
    scene: Scene,
    frequency,
    *,
    eta_r: torch.Tensor,
    conductivity: torch.Tensor,
    thickness: torch.Tensor | None = None,
    tx_pattern=None,
) -> torch.Tensor:
    """Complex channel amplitude of every traced path (V polarization), ``[*batch]``.

    Applies the free-space 1/s spreading, the propagation phase, the
    per-bounce slab-aware Fresnel Jones chain and the isotropic
    ``lambda / (4 pi)`` scaling; invalid paths contribute 0, and a float
    ``paths.mask`` weights each path by its confidence. Paths whose
    geometry is not usable (non-finite, or a zero-length segment) are
    computed on a harmless straight dummy path and weighted 0: a zero
    weight alone would not do, as ``0 * inf`` in a backward is NaN. The
    substitution looks at the geometry, not at the mask: a path of low
    confidence still contributes its own amplitude times that confidence.

    With a ``tx_pattern`` (a :class:`~differt_tpu_torch.em.RadiationPattern`)
    the launch field follows the pattern, evaluated one metre from its
    centre along each path's departure: its (s, p) vectors projected on the
    first segment's spherical frame replace the unit vertical polarization
    of an isotropic antenna.
    """
    with annotate("em"):
        device = paths.vertices.device
        frequency = torch.as_tensor(frequency, dtype=torch.float32, device=device)
        eta_r = torch.as_tensor(eta_r, dtype=torch.float32, device=device)
        conductivity = torch.as_tensor(conductivity, dtype=torch.float32, device=device)
        omega = 2.0 * math.pi * frequency
        n_complex = torch.sqrt(eta_r - 1j * conductivity / (omega * epsilon_0))
        wavelength = c / frequency
        if thickness is None:
            thickness = torch.full_like(eta_r, -1.0)
        else:
            thickness = torch.as_tensor(thickness, dtype=torch.float32, device=device)

        num_points = paths.vertices.shape[-2]
        order = paths.order
        # [*batch, L, 3] -> [L, 3, *batch]: one tensor per (point, axis).
        v_soa = torch.movedim(paths.vertices, (-2, -1), (0, 1))
        diffs = v_soa[1:] - v_soa[:-1]
        seg_ok = (diffs * diffs).sum(dim=1).amin(dim=0) > 1e-12
        geom_finite = torch.isfinite(v_soa).all(dim=1).all(dim=0) & seg_ok
        pts = [
            [
                torch.where(geom_finite, v_soa[l, axis], float(l) if axis == 0 else 0.0)
                for axis in range(3)
            ]
            for l in range(num_points)
        ]

        k_hats, s_lens = [], []
        for i in range(num_points - 1):
            k_hat, s_len = normalize3(tuple(pts[i + 1][ax] - pts[i][ax] for ax in range(3)))
            k_hats.append(k_hat)
            s_lens.append(s_len)

        if tx_pattern is None:
            e_theta = torch.ones(paths.mask.shape, dtype=torch.complex64, device=device)
            e_phi = torch.zeros(paths.mask.shape, dtype=torch.complex64, device=device)
        else:
            k0 = k_hats[0]
            r_eval = tx_pattern.center + torch.stack(k0, dim=-1)
            s_vec, p_vec = tx_pattern.polarization_vectors(r_eval)
            e_vec = tuple(s_vec[..., axis] + p_vec[..., axis] for axis in range(3))
            th0, ph0 = spherical3(k0)
            e_theta = dot3(e_vec, th0).to(torch.complex64)
            e_phi = dot3(e_vec, ph0).to(torch.complex64)

        if order > 0:
            mesh = scene.mesh
            normals_t = mesh.normals
            is_reflection = paths.interaction_types == 0
            num_tri = normals_t.shape[0]
            if mesh.face_materials is None:
                n_r_tri = n_complex[0].expand(num_tri)
                thick_tri = thickness[0].expand(num_tri)
            else:
                # Clamped gathers: a face material beyond the supplied table
                # takes its last entry instead of poisoning the pixel sum.
                mats = mesh.face_materials.clamp(0, n_complex.shape[0] - 1)
                n_r_tri = n_complex[mats]
                thick_tri = thickness[mats]
            table = torch.cat(
                (
                    normals_t.to(torch.float32),
                    n_r_tri.real[:, None],
                    n_r_tri.imag[:, None],
                    thick_tri[:, None],
                ),
                dim=-1,
            )

            for b in range(order):
                # A bounce padded by `pad_order` (object -1) reads row 0 and is
                # passed over below (its type is -1).
                cols = gather_columns(table, paths.objects[..., b + 1].clamp(min=0))
                normal = (cols[0], cols[1], cols[2])
                n_r_val = torch.complex(cols[3], cols[4])
                thickness_val = cols[5]

                k_in, k_out = k_hats[b], k_hats[b + 1]
                th_in, ph_in = spherical3(k_in)
                th_out, ph_out = spherical3(k_out)
                (e_i_s, e_i_p), (e_r_s, e_r_p) = sp_directions3(k_in, k_out, normal)
                cos_theta_i = -dot3(normal, k_in)
                r_s, r_p = slab_reflection_coefficients(
                    n_r_val, cos_theta_i, thickness_val, wavelength
                )

                # (theta, phi) -> local (s, p), scale, -> next (theta, phi).
                f_s = r_s * (dot3(e_i_s, th_in) * e_theta + dot3(e_i_s, ph_in) * e_phi)
                f_p = r_p * (dot3(e_i_p, th_in) * e_theta + dot3(e_i_p, ph_in) * e_phi)
                new_theta = dot3(th_out, e_r_s) * f_s + dot3(th_out, e_r_p) * f_p
                new_phi = dot3(ph_out, e_r_s) * f_s + dot3(ph_out, e_r_p) * f_p

                keep = is_reflection[..., b]
                e_theta = torch.where(keep, new_theta, e_theta)
                e_phi = torch.where(keep, new_phi, e_phi)

        k_last = k_hats[-1]
        theta_hat_last, _ = spherical3(k_last)
        theta_hat_neg, _ = spherical3(tuple(-comp for comp in k_last))
        a = dot3(theta_hat_last, theta_hat_neg) * e_theta

        s_tot = s_lens[0]
        for s_len in s_lens[1:]:
            s_tot = s_tot + s_len
        spreading = safe_divide(torch.ones_like(s_tot), s_tot)
        phase = -2.0 * math.pi * frequency * s_tot / c
        a = a * spreading * torch.complex(torch.cos(phase), torch.sin(phase))
        a = a * (wavelength / (4 * math.pi))

        weight = paths.mask.to(torch.float32) * geom_finite.to(torch.float32)
        # complex * float multiplies both parts: no complex-valued backward of
        # the weight enters a gradient through the confidence.
        return a * weight


def received_power(
    paths: TracedPaths,
    scene: Scene,
    frequency,
    *,
    eta_r: torch.Tensor,
    conductivity: torch.Tensor,
    thickness: torch.Tensor | None = None,
    coherent: bool = True,
    tx_pattern=None,
) -> torch.Tensor:
    """Received power per TX/RX pair; the last (candidate) axis of ``paths`` is summed."""
    a = complex_amplitudes(
        paths,
        scene,
        frequency,
        eta_r=eta_r,
        conductivity=conductivity,
        thickness=thickness,
        tx_pattern=tx_pattern,
    )
    if coherent:
        return torch.abs(a.sum(dim=-1)) ** 2 / z_0
    return (torch.abs(a) ** 2).sum(dim=-1) / z_0


def resolve_materials(scene: Scene, frequency: torch.Tensor, eta_r, conductivity, thickness):
    """A call's materials, float32 on the mesh's device; the ITU table's at ``frequency`` where ``eta_r`` or ``conductivity`` is None."""
    device = scene.mesh.device
    if eta_r is None or conductivity is None:
        names = scene.mesh.material_names or ("Vacuum",)
        eta_r = torch.stack([materials[n].relative_permittivity(frequency) for n in names])
        conductivity = torch.stack([materials[n].conductivity(frequency) for n in names])
        thickness = torch.tensor(
            [
                materials[n].thickness if materials[n].thickness is not None else -1.0
                for n in names
            ]
        )
    as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).to(device)  # noqa: E731
    return as_f32(eta_r), as_f32(conductivity), None if thickness is None else as_f32(thickness)


def power_map(
    scene: Scene,
    frequency,
    *,
    order: int = 1,
    eta_r: torch.Tensor | None = None,
    conductivity: torch.Tensor | None = None,
    thickness: torch.Tensor | None = None,
    coherent: bool = True,
    solver="exhaustive",
    with_diffraction: bool = False,
    with_scattering: bool = False,
    scattering_coefficient=0.3,
    tx_pattern=None,
    mixed_signatures=None,
    **solver_kwargs,
) -> torch.Tensor:
    """Coverage map: received power for every TX/RX pair, ``[*tx_batch, *rx_batch]``.

    Materials default to the ITU table at ``frequency``. ``solver`` and
    ``solver_kwargs`` go to :meth:`Scene.trace_paths
    <differt_tpu_torch.geometry.Scene.trace_paths>` (``"exhaustive"``,
    ``"hybrid"`` or a tracer instance); ``tx_pattern`` to
    :func:`complex_amplitudes`. Three options add paths to the specular
    ones:

    - ``with_diffraction``: the first-order UTD edge-diffraction paths of
      :class:`~differt_tpu_torch.rt.DiffractionPathTracer`, whose wedges are
      perfectly conducting;
    - ``mixed_signatures``: a sequence of interaction-type signatures (e.g.
      ``[(REFLECTION, DIFFRACTION)]``), each traced by
      :class:`~differt_tpu_torch.rt.MixedPathTracer` (Fermat paths) and
      weighted by :func:`~differt_tpu_torch.rt.mixed_amplitudes` with the
      materials; the edges are extracted once for both options;
    - ``with_scattering``: single-bounce diffuse scattering
      (:class:`~differt_tpu_torch.rt.ScatteringPathTracer`, Lambertian
      effective roughness, ``scattering_coefficient`` ``S`` per material or
      a scalar). The specular amplitudes are scaled by ``sqrt(1 - S^2)``
      per bounce, and the scattered power adds after the sum, whatever
      ``coherent`` says: its phases are random in nature.

    The diffraction and mixed amplitudes add to the specular ones per pixel
    (``coherent``), or their powers do.

    >>> import torch
    >>> from differt_tpu_torch.geometry import Mesh, Scene
    >>> mesh = Mesh.box(20.0, 10.0, 6.0, with_top=False, device="cpu").set_materials("Concrete")
    >>> scene = Scene(transmitters=torch.tensor([[-5.0, 0.0, 1.0]]), mesh=mesh)
    >>> power = power_map(scene.with_receivers_grid(4, 2, height=1.0), 2.4e9, order=1)
    >>> tuple(power.shape), bool((power > 0).all())
    ((1, 2, 4), True)
    """
    frequency = torch.as_tensor(frequency, dtype=torch.float32, device=scene.mesh.device)
    eta_r, conductivity, thickness = resolve_materials(
        scene, frequency, eta_r, conductivity, thickness
    )
    paths = scene.trace_paths(order=order, solver=solver, **solver_kwargs)
    if not with_diffraction and not with_scattering and not mixed_signatures:
        return received_power(
            paths,
            scene,
            frequency,
            eta_r=eta_r,
            conductivity=conductivity,
            thickness=thickness,
            coherent=coherent,
            tx_pattern=tx_pattern,
        )

    num_tx = max(math.prod(scene.transmitters.shape[:-1]), 1)
    num_rx = max(math.prod(scene.receivers.shape[:-1]), 1)
    tx = scene.transmitters.reshape(-1, 3)
    rx = scene.receivers.reshape(-1, 3)
    paths = paths.reshape(num_tx, num_rx, -1)
    a_spec = complex_amplitudes(
        paths,
        scene,
        frequency,
        eta_r=eta_r,
        conductivity=conductivity,
        thickness=thickness,
        tx_pattern=tx_pattern,
    )
    if with_scattering:
        # Energy conservation (effective roughness): a surface that scatters
        # a fraction S^2 of the incident power reflects the specular field
        # scaled by sqrt(1 - S^2), once per bounce.
        s_arr = torch.as_tensor(scattering_coefficient, dtype=torch.float32, device=frequency.device)
        obj = paths.objects[..., 1:-1]
        if s_arr.ndim == 0 or scene.mesh.face_materials is None:
            s_per_bounce = s_arr.reshape(-1)[0].expand(obj.shape)
        else:
            s_per_bounce = s_arr[scene.mesh.face_materials.clamp(0, s_arr.shape[0] - 1)[obj]]
        a_spec = a_spec * torch.sqrt(1.0 - s_per_bounce**2).prod(dim=-1)

    extra_amplitudes = []
    if with_diffraction or mixed_signatures:
        # The edges are extracted once, for the tracers and the amplitudes.
        mesh = scene.mesh if scene.mesh.assume_unique_vertices else scene.mesh.dedup_vertices()
        edges, adjacent, wedge_n = mesh._diffraction_edges_info()

    if with_diffraction:
        from .rt._diffraction import _trace_diffraction, diffraction_amplitudes

        diff_paths = _trace_diffraction(mesh, tx, rx, edges, hit_tol=None, min_len=None)
        extra_amplitudes.append(
            diffraction_amplitudes(
                diff_paths.reshape(num_tx, num_rx, -1),
                scene,
                frequency,
                edges=edges,
                adjacent_triangles=adjacent,
                wedge_n=wedge_n,
            )
        )

    if mixed_signatures:
        from .rt._mixed import MixedPathTracer, mixed_amplitudes

        tracer = MixedPathTracer()
        for signature in mixed_signatures:
            mixed_paths = tracer.trace_with_edges(scene, mesh, edges, signature)
            extra_amplitudes.append(
                mixed_amplitudes(
                    mixed_paths.reshape(num_tx, num_rx, -1),
                    scene,
                    frequency,
                    edges=edges,
                    adjacent_triangles=adjacent,
                    wedge_n=wedge_n,
                    eta_r=eta_r,
                    conductivity=conductivity,
                    thickness=thickness,
                    types=signature,
                )
            )

    if coherent:
        total = a_spec.sum(dim=-1)
        for a in extra_amplitudes:
            total = total + a.sum(dim=-1)
        power = torch.abs(total) ** 2 / z_0
    else:
        power = (torch.abs(a_spec) ** 2).sum(dim=-1) / z_0
        for a in extra_amplitudes:
            power = power + (torch.abs(a) ** 2).sum(dim=-1) / z_0

    if with_scattering:
        from .rt._scattering import scattering_amplitudes

        scatter_paths = scene.trace_scattering_paths()
        a_scatter = scattering_amplitudes(
            scatter_paths.reshape(num_tx, num_rx, -1),
            scene,
            frequency,
            eta_r=eta_r,
            conductivity=conductivity,
            scattering_coefficient=scattering_coefficient,
        )
        # Scattered phases are random surface noise: the power adds.
        power = power + (torch.abs(a_scatter) ** 2).sum(dim=-1) / z_0

    return power.reshape(*scene.transmitters.shape[:-1], *scene.receivers.shape[:-1])


def _fused_em(device: torch.device, order: int, hard: bool, tx_pattern, inputs) -> bool:
    """Whether a coverage tile's EM chain and pixel sum run as one kernel.

    Where the tile's paths lie on the card (the "cuda" backend, or "auto"
    on CUDA tensors), no input can be asked for a gradient, there is no
    antenna pattern, the mask is ``hard`` (bool) and the order is one the
    kernel takes. A gradient needs each path's amplitude in a graph, which
    the plain chain keeps; a smoothed mask and a pattern stay with it too.
    """
    from .ops import get_backend
    from .ops._trace import MAX_ORDER

    return (
        get_backend(device) == "cuda"
        and tx_pattern is None
        and hard
        and order <= MAX_ORDER
        and not (
            torch.is_grad_enabled()
            and any(isinstance(x, torch.Tensor) and x.requires_grad for x in inputs)
        )
    )


@dataclasses.dataclass(frozen=True)
class _TilePlan:
    """What the kernels of a set's tiles read of one candidate set and call, laid out once (:func:`_tile_plan`).

    Each per-candidate tensor spans the whole padded set, so that chunk
    ``lo:hi`` is a contiguous slice of it, equal bit for bit to the chunk's
    own layout. The EM half is always there; the trace half (``mirrors``
    to ``bvh``) only where the trace is fused, else None.
    """

    objects: torch.Tensor  # [C, order] int64, ops._em.em_rows
    types: torch.Tensor  # [C, order] int32
    valid: torch.Tensor  # [C]: not padding
    em_inputs: tuple  # normals, face materials, material table, frequency: ops._em.em_mesh_inputs
    mirrors: torch.Tensor | None  # [C, order, 6], ops._trace.trace_layout
    cand_tris: torch.Tensor | None  # [C, tpm * order, 9]
    active_rays: torch.Tensor | None  # [C]: every triangle active (None: the mesh has no mask)
    bvh: Any


@dataclasses.dataclass(frozen=True)
class _CandidateSet:
    """A candidate set padded to whole chunks with copies of its first candidate (:class:`_TileWalk`)."""

    candidates: torch.Tensor  # [C, order], C a whole number of chunks
    interaction_types: torch.Tensor | None  # [C, order]; None: reflections
    num_candidates: int  # before padding: candidates from here on are masked out
    chunk: int
    plan: _TilePlan | None = None


def _tile_plan(
    mesh,
    tx: torch.Tensor,
    rx: torch.Tensor,
    candidate_set: _CandidateSet,
    frequency: torch.Tensor,
    eta_r: torch.Tensor,
    conductivity: torch.Tensor,
    thickness: torch.Tensor | None,
    *,
    megakernel: bool | None,
    smoothing_factor,
    tx_pattern,
) -> _TilePlan | None:
    """A plan for the tiles of a padded candidate set in one call, or None where they take the plain chain.

    Where :func:`_fused_em` holds of the call (of all a tile reads), the EM
    kernel's rows and mesh inputs are laid out here, and where the trace is
    fused (``rt._solvers.fused_trace``) the trace kernel's inputs too; each
    tile then makes only the launches that depend on its receivers
    (:func:`_coverage_tile`). In the span ``tile.prep``, once per set and call.
    """
    candidates = candidate_set.candidates
    num_cand, order = candidates.shape
    device = mesh.device
    inputs = (tx, rx, frequency, eta_r, conductivity, thickness, mesh.vertices)
    if not _fused_em(device, order, smoothing_factor is None, tx_pattern, inputs):
        return None
    from .ops._em import em_mesh_inputs, em_rows
    from .ops._trace import trace_layout
    from .rt._solvers import candidate_geometry, candidate_rows, fused_trace

    with annotate("tile.prep"):
        em_inputs = em_mesh_inputs(mesh, frequency, eta_r, conductivity, thickness, device)
        # A bounce's object is its candidate's primitive (a quad's first triangle), as the trace expands it.
        objects, types = em_rows(*candidate_rows(candidates, candidate_set.interaction_types), device)
        mirrors = cand_tris = active_rays = bvh = None
        if order >= 1 and fused_trace(megakernel, device, order, num_cand, smoothing_factor):
            path_candidates, triangle_vertices, mirror_vertices, mirror_normals = candidate_geometry(
                mesh, candidates, normals=em_inputs[0]
            )
            mirrors, cand_tris = trace_layout(mirror_vertices, mirror_normals, triangle_vertices)
            active_rays = None if mesh.mask is None else mesh.mask[path_candidates].all(dim=-1)
            bvh = mesh.bvh
        valid = torch.arange(num_cand, device=device) < candidate_set.num_candidates
        return _TilePlan(objects, types, valid, em_inputs, mirrors, cand_tris, active_rays, bvh)


class _TileWalk:
    """The (RX tile, candidate chunk) pairs of a map or a streamed step: RX tiles, then sets, then chunks.

    Pads the receivers to whole tiles of ``rx_chunk`` and each candidate set
    (``(candidates, interaction_types)``, None: reflections) to whole chunks
    of ``candidate_chunk``, each with copies of its first row. Yields each
    tile's RX row and tile, its set and its candidates ``lo:hi``; a row
    sums over every set's chunks, so over the orders.
    """

    def __init__(self, rx: torch.Tensor, rx_chunk: int, candidate_sets, candidate_chunk: int) -> None:
        self.num_rx = rx.shape[0]
        self.rx_chunk = min(rx_chunk, max(self.num_rx, 1))
        self.pad_r = -self.num_rx % self.rx_chunk
        self.rx = torch.cat((rx, rx[:1].expand(self.pad_r, 3))) if self.pad_r else rx
        self.sets = []
        for candidates, types in candidate_sets:
            n = candidates.shape[0]
            chunk = min(candidate_chunk, max(n, 1))
            pad = -n % chunk
            if pad:
                candidates = torch.cat((candidates, candidates[:1].expand(pad, -1)))
                types = None if types is None else torch.cat((types, types[:1].expand(pad, -1)))
            self.sets.append(_CandidateSet(candidates, types, n, chunk))

    def planned(self, mesh, tx, *call, **options) -> "_TileWalk":
        """This walk with each set's plan for one call (``call`` and ``options``: :func:`_tile_plan`'s, after the set)."""
        walk = copy.copy(self)
        walk.sets = [dataclasses.replace(s, plan=_tile_plan(mesh, tx, self.rx, s, *call, **options)) for s in self.sets]
        return walk

    def __iter__(self) -> Iterator[tuple[int, torch.Tensor, _CandidateSet, int, int]]:
        for row, r0 in enumerate(range(0, self.rx.shape[0], self.rx_chunk)):
            rx_tile = self.rx[r0 : r0 + self.rx_chunk]
            for s in self.sets:
                for lo in range(0, s.candidates.shape[0], s.chunk):
                    yield row, rx_tile, s, lo, lo + s.chunk


def _coverage_tile(
    scene: Scene,
    tx: torch.Tensor,
    rx_tile: torch.Tensor,
    candidate_set: _CandidateSet,
    lo: int,
    hi: int,
    plan: _TilePlan | None,
    frequency: torch.Tensor,
    eta_r: torch.Tensor,
    conductivity: torch.Tensor,
    thickness: torch.Tensor | None,
    coherent: bool,
    megakernel: bool | None,
    batch_size: int | None = 512,
    smoothing_factor: float | torch.Tensor | None = None,
    tx_pattern=None,
) -> torch.Tensor:
    """One (RX tile, candidate chunk) step of a map or a streamed step: candidates ``lo:hi`` of a padded set.

    Returns the complex path sum (``coherent``) or the power sum per
    ``[num_tx, rx_chunk]`` pixel; padded candidates are masked out. With a
    ``smoothing_factor`` the checks are sigmoids and each path's amplitude
    is weighted by its confidence.

    Two halves, each on the set's ``plan`` (:func:`_tile_plan`) where it
    has one. The trace: the fused kernel on the plan's slices where the plan
    holds the trace half, else ``rt._solvers.trace_geometry``. The EM chain
    and the sum: one kernel (``csrc/em.cu``) on the plan's rows where there
    is a plan, else :func:`complex_amplitudes` per path.
    """
    from .ops._em import em_laid_out
    from .ops._trace import trace_laid_out
    from .rt._solvers import _assemble_traced_paths, kernel_tolerances, trace_geometry

    num_candidates = candidate_set.num_candidates
    with annotate("tile"):
        if plan is not None and plan.mirrors is not None:
            epsilon, hit_tol, min_len = kernel_tolerances()
            vertices, mask = trace_laid_out(
                tx.contiguous(),
                rx_tile.contiguous(),
                plan.mirrors[lo:hi],
                plan.cand_tris[lo:hi],
                None,
                None,
                order=plan.mirrors.shape[1],
                epsilon=epsilon,
                hit_tol=hit_tol,
                min_len=min_len,
                bvh=plan.bvh,
            )
            # [tx, cand, rx] -> [tx, rx, cand]
            vertices, mask = vertices.transpose(1, 2), mask.transpose(1, 2)
            if plan.active_rays is not None:
                mask = mask & plan.active_rays[lo:hi]
        else:
            cand_chunk = candidate_set.candidates[lo:hi]
            vertices, mask, triangles, k = trace_geometry(
                scene.mesh,
                tx,
                rx_tile,
                cand_chunk,
                megakernel=megakernel,
                batch_size=batch_size,
                smoothing_factor=smoothing_factor,
            )
        # The padding's mask: a planned tile slices its plan's, on the chunk that holds padding only.
        if plan is None:
            valid = torch.arange(lo, hi, device=candidate_set.candidates.device) < num_candidates
        else:
            valid = plan.valid[lo:hi] if hi > num_candidates else None
        if valid is not None:
            if mask.dtype == torch.bool:
                mask = mask & valid
            else:  # a confidence is weighted, not AND-ed
                mask = mask * valid.to(mask.dtype)
        if plan is not None:
            with annotate("em"):
                return em_laid_out(
                    vertices, mask, plan.objects[lo:hi], plan.types[lo:hi], *plan.em_inputs, coherent=coherent
                )
        types = candidate_set.interaction_types
        paths = _assemble_traced_paths(
            vertices, mask, triangles, None if types is None else types[lo:hi], k,
            tx.shape[0], rx_tile.shape[0], *cand_chunk.shape,
        )
        a = complex_amplitudes(
            paths,
            scene,
            frequency,
            eta_r=eta_r,
            conductivity=conductivity,
            thickness=thickness,
            tx_pattern=tx_pattern,
        )
        if coherent:
            return a.sum(dim=-1)
        return (torch.abs(a) ** 2).sum(dim=-1)


def power_map_chunked(
    scene: Scene,
    frequency,
    *,
    order: int = 1,
    eta_r: torch.Tensor | None = None,
    conductivity: torch.Tensor | None = None,
    thickness: torch.Tensor | None = None,
    coherent: bool = True,
    solver="exhaustive",
    path_candidates: torch.Tensor | None = None,
    candidate_chunk: int = 4096,
    rx_chunk: int = 4096,
    tx_pattern=None,
    megakernel: bool | None = None,
    batch_size: int | None = 512,
    smoothing_factor: float | torch.Tensor | None = None,
) -> torch.Tensor:
    """Coverage map streamed through fixed-size tiles, ``[*tx_batch, *rx_batch]``.

    Candidates go ``candidate_chunk`` at a time through each RX tile of
    ``rx_chunk`` receivers, accumulating the complex path sum (or the power
    sum) per pixel. The receivers are Morton-ordered first, so each tile is
    spatially compact; the map is scattered back to input order.
    ``path_candidates`` overrides the candidate set, which ``solver``
    otherwise generates (``"exhaustive"``, ``"hybrid"`` or a tracer
    instance: its ``generate_path_candidates``); ``smoothing_factor`` and
    ``batch_size`` go to the trace
    (:func:`~differt_tpu_torch.rt.trace_path_candidates`), ``tx_pattern``
    to :func:`complex_amplitudes`.
    """
    with annotate("coverage.map"):
        from .ops._rt import morton_perm_points
        from .rt._solvers import _SOLVER_REGISTRY

        device = scene.mesh.device
        frequency = torch.as_tensor(frequency, dtype=torch.float32, device=device)
        eta_r, conductivity, thickness = resolve_materials(
            scene, frequency, eta_r, conductivity, thickness
        )
        tx = scene.transmitters.reshape(-1, 3)
        rx_all = scene.receivers.reshape(-1, 3)

        if path_candidates is None:
            tracer = _SOLVER_REGISTRY[solver]() if isinstance(solver, str) else solver
            candidates, itypes = tracer.generate_path_candidates(scene, order)
        else:
            candidates, itypes = torch.as_tensor(path_candidates, device=device), None

        num_rx = rx_all.shape[0]
        rx_perm = None
        if num_rx > rx_chunk:
            rx_perm = morton_perm_points(rx_all)
            rx_all = rx_all[rx_perm]
        walk = _TileWalk(rx_all, rx_chunk, [(candidates, itypes)], candidate_chunk).planned(
            scene.mesh, tx, frequency, eta_r, conductivity, thickness,
            megakernel=megakernel,
            smoothing_factor=smoothing_factor,
            tx_pattern=tx_pattern,
        )
        out_tiles = []  # one sum per RX tile; the tiles come row by row
        for row, rx_tile, s, lo, hi in walk:
            part = _coverage_tile(
                scene, tx, rx_tile, s, lo, hi, s.plan, frequency, eta_r, conductivity, thickness,
                coherent, megakernel, batch_size, smoothing_factor, tx_pattern,
            )
            if row == len(out_tiles):
                out_tiles.append(part)
            else:
                out_tiles[row] = out_tiles[row] + part

        total = torch.cat(out_tiles, dim=-1)[..., :num_rx]
        if rx_perm is not None:
            total = total[..., torch.argsort(rx_perm)]
        power = torch.abs(total) ** 2 / z_0 if coherent else total / z_0
        return power.reshape(*scene.transmitters.shape[:-1], *scene.receivers.shape[:-1])
