"""The port's plotting adapter, the ``plot`` methods and the path containers' iteration, against the JAX package's.

``tests/test_plotting.py``'s cases on the matplotlib backend (Agg), then
each figure's data held against the one the JAX package draws from the
same inputs, within float32: a mesh's and a surface's polygon vertices,
the paths' line data, the markers, the image. Plotly and vispy are not
installed here: their cases skip.
"""

import warnings

import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

from differt_tpu import plotting as jax_plotting  # noqa: E402
from differt_tpu.em import HWDipolePattern as JaxHWDipolePattern  # noqa: E402
from differt_tpu.em import Dipole as JaxDipole  # noqa: E402
from differt_tpu.geometry import LaunchedPaths as JaxLaunchedPaths  # noqa: E402
from differt_tpu.geometry import Mesh as JaxMesh  # noqa: E402
from differt_tpu.geometry import Scene as JaxScene  # noqa: E402
from differt_tpu_torch import plotting  # noqa: E402
from differt_tpu_torch.em import HWDipolePattern  # noqa: E402
from differt_tpu_torch.geometry import LaunchedPaths, Mesh, Paths, SBRPaths, Scene, TracedPaths  # noqa: E402

from .torch_parity import to_torch_antenna, to_torch_scene  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def mpl_backend():
    old = plotting.get_backend(), jax_plotting.get_backend()
    plotting.set_backend("matplotlib")
    jax_plotting.set_backend("matplotlib")
    yield
    plotting.set_backend(old[0])
    jax_plotting.set_backend(old[1])
    plt.close("all")


def polygons(fig) -> np.ndarray:
    """The homogeneous vertex coordinates of the first axes' polygon collection."""
    return np.asarray(fig.axes[0].collections[0]._vec)


def lines(fig) -> list[np.ndarray]:
    return [np.asarray(line.get_data_3d()) for line in fig.axes[0].lines]


def assert_lines_equal(got, want) -> None:
    assert len(got) == len(want) > 0
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_backend_dispatch() -> None:
    assert plotting.get_backend() == "matplotlib"
    with pytest.raises(ValueError, match="Unsupported backend"):
        plotting.set_backend("vispy3d")
    with plotting.use("matplotlib"):
        assert plotting.get_backend() == "matplotlib"


def test_draw_mesh_matches_jax() -> None:
    got = plotting.draw_mesh(Mesh.box(with_top=True, device="cpu"))
    want = jax_plotting.draw_mesh(JaxMesh.box(with_top=True))
    assert got.axes and polygons(got).shape == polygons(want).shape
    np.testing.assert_allclose(polygons(got), polygons(want), rtol=1e-6, atol=1e-6)


def test_draw_paths_and_rays_match_jax() -> None:
    rng = np.random.default_rng(3)
    paths = rng.normal(size=(2, 2, 4, 3)).astype(np.float32)
    assert_lines_equal(
        lines(plotting.draw_paths(torch.from_numpy(paths))), lines(jax_plotting.draw_paths(jnp.asarray(paths)))
    )
    origins, directions = rng.normal(size=(2, 5, 3)).astype(np.float32)
    assert_lines_equal(
        lines(plotting.draw_rays(torch.from_numpy(origins), torch.from_numpy(directions))),
        lines(jax_plotting.draw_rays(jnp.asarray(origins), jnp.asarray(directions))),
    )


def test_draw_paths_takes_tensors_that_need_a_gradient() -> None:
    paths = torch.zeros((1, 3, 3), requires_grad=True)
    fig = plotting.draw_paths(paths * 2.0)
    assert len(fig.axes[0].lines) == 1


def test_draw_markers_with_labels_match_jax() -> None:
    markers = np.random.default_rng(4).normal(size=(2, 3)).astype(np.float32)
    got = plotting.draw_markers(torch.from_numpy(markers), labels=["tx", "rx"])
    want = jax_plotting.draw_markers(jnp.asarray(markers), labels=["tx", "rx"])
    np.testing.assert_allclose(
        np.asarray(got.axes[0].collections[0]._offsets3d),
        np.asarray(want.axes[0].collections[0]._offsets3d),
        rtol=1e-6,
    )
    assert [t.get_text() for t in got.axes[0].texts] == [t.get_text() for t in want.axes[0].texts] == ["tx", "rx"]


def test_draw_image_and_surface_match_jax() -> None:
    data = np.random.default_rng(0).random((8, 8)).astype(np.float32)
    got = plotting.draw_image(torch.from_numpy(data))
    want = jax_plotting.draw_image(jnp.asarray(data))
    np.testing.assert_array_equal(got.axes[0].images[0].get_array(), want.axes[0].images[0].get_array())
    x, y = np.meshgrid(np.arange(8.0, dtype=np.float32), np.arange(8.0, dtype=np.float32))
    got = plotting.draw_surface(x=torch.from_numpy(x), y=torch.from_numpy(y), z=torch.from_numpy(data))
    want = jax_plotting.draw_surface(x=jnp.asarray(x), y=jnp.asarray(y), z=jnp.asarray(data))
    np.testing.assert_allclose(polygons(got), polygons(want), rtol=1e-6, atol=1e-6)


def test_draw_contour() -> None:
    data = np.random.default_rng(1).random((8, 8)).astype(np.float32)
    fig = plotting.draw_contour(torch.from_numpy(data), levels=3)
    assert fig.axes and fig.axes[0].collections


def test_reuse_accumulates() -> None:
    with plotting.reuse(backend="matplotlib") as fig:
        plotting.draw_markers(torch.zeros((1, 3)))
        plotting.draw_paths(torch.zeros((1, 2, 3)))
    assert fig.axes
    assert len(fig.axes[0].lines) >= 1


def test_reuse_constructor_kwargs() -> None:
    with plotting.reuse(backend="matplotlib", figsize=(3.0, 2.0)) as fig:
        plotting.draw_markers(torch.zeros((1, 3)))
    assert tuple(fig.get_size_inches()) == (3.0, 2.0)


def test_reuse_pass_all_kwargs_forwards_to_draws() -> None:
    paths = torch.zeros((1, 2, 3))
    paths[:, 1, 0] = 1.0
    with plotting.reuse(backend="matplotlib", pass_all_kwargs=True, color="red") as fig:
        plotting.draw_paths(paths)
    assert fig.axes[0].lines[0].get_color() == "red"


def test_reuse_kwargs_do_not_leak_outside_context() -> None:
    with plotting.reuse(backend="matplotlib", pass_all_kwargs=True, color="red"):
        plotting.draw_paths(torch.zeros((1, 2, 3)))
    fig = plotting.draw_paths(torch.ones((1, 2, 3)))
    assert fig.axes[0].lines[0].get_color() != "red"


def test_per_call_kwargs_override_reuse_kwargs() -> None:
    with plotting.reuse(backend="matplotlib", pass_all_kwargs=True, color="red") as fig:
        plotting.draw_paths(torch.zeros((1, 2, 3)), color="blue")
    assert fig.axes[0].lines[0].get_color() == "blue"


def test_defaults_registry() -> None:
    from differt_tpu_torch.plotting._utils import merged_kwargs

    plotting.set_defaults("matplotlib", color="green")
    try:
        assert merged_kwargs("matplotlib", {}) == {"color": "green"}
        plotting.update_defaults("matplotlib", linewidth=2)
        assert merged_kwargs("matplotlib", {}) == {"color": "green", "linewidth": 2}
        assert merged_kwargs("matplotlib", {"color": "black"})["color"] == "black"
    finally:
        plotting.set_defaults("matplotlib")


def test_dispatch_routes_by_backend() -> None:
    @plotting.dispatch
    def primitive():
        """A primitive."""

    primitive.register("matplotlib")(lambda: "mpl")
    assert primitive() == "mpl" and primitive.__doc__ == "A primitive."
    with pytest.raises(NotImplementedError, match="plotly"):
        primitive(backend="plotly")


def test_scene_plot_forwards_kwargs() -> None:
    scene = Scene(transmitters=torch.tensor([-1.0, 0.0, 0.0]), mesh=Mesh.box(with_top=True, device="cpu"))
    with pytest.raises(AttributeError):  # the unknown keyword reaches matplotlib
        scene.plot(backend="matplotlib", not_a_real_kwarg=object())


def small_scene() -> JaxScene:
    return JaxScene(
        transmitters=jnp.array([-1.0, 0.0, 0.0]),
        receivers=jnp.array([[1.0, 0.5, 0.0], [1.0, -0.5, 0.5]]),
        mesh=JaxMesh.box(4.0, 4.0, 4.0, with_top=True),
    )


def test_mesh_scene_and_traced_paths_plot_as_jax_does() -> None:
    ref = small_scene()
    port = to_torch_scene(ref)
    np.testing.assert_allclose(polygons(port.mesh.plot()), polygons(ref.mesh.plot()), rtol=1e-6, atol=1e-6)
    got, want = port.plot(backend="matplotlib"), ref.plot(backend="matplotlib")
    np.testing.assert_allclose(polygons(got), polygons(want), rtol=1e-6, atol=1e-6)
    offsets = [np.asarray(c._offsets3d) for c in got.axes[0].collections[1:]]
    want_offsets = [np.asarray(c._offsets3d) for c in want.axes[0].collections[1:]]
    assert len(offsets) == 2
    for a, b in zip(offsets, want_offsets, strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    paths, ref_paths = port.trace_paths(order=1), ref.trace_paths(order=1)
    assert_lines_equal(lines(paths.plot()), lines(ref_paths.plot()))


def launched(seed: int = 7):
    """The same random launched paths for both packages: batch (2, 3), order 2."""
    rng = np.random.default_rng(seed)
    fields = {
        "vertices": rng.normal(size=(2, 3, 4, 3)).astype(np.float32),
        "objects": rng.integers(0, 10, (2, 3, 4)).astype(np.int32),
        "masks": rng.random((2, 3, 3)) < 0.6,
        "interaction_types": np.zeros((2, 3, 2), np.int32),
    }
    fields["masks"][0, 0] = False  # some paths invalid at every order
    port = LaunchedPaths(**{k: torch.from_numpy(v) for k, v in fields.items()})
    ref = JaxLaunchedPaths(**{k: jnp.asarray(v) for k, v in fields.items()})
    return port, ref


def test_launched_paths_masked_match_jax() -> None:
    port, ref = launched()
    got, want = port.masked(), ref.masked()
    assert got.shape == tuple(want.shape) and 0 < got.shape[0] < 6
    np.testing.assert_array_equal(got.vertices.numpy(), np.asarray(want.vertices))
    np.testing.assert_array_equal(port.masked_vertices.numpy(), np.asarray(ref.masked_vertices))
    np.testing.assert_array_equal(port.masked_objects.numpy(), np.asarray(ref.masked_objects))
    assert bool(got.mask.all())


def test_launched_and_traced_paths_iterate_as_jax_does() -> None:
    port, ref = launched()
    got, want = list(port), list(ref)
    assert len(got) == len(want) == int(port.mask.sum())
    for a, b in zip(got, want, strict=True):
        assert a.shape == () and bool(a.mask)
        np.testing.assert_array_equal(a.vertices.numpy(), np.asarray(b.vertices))
        np.testing.assert_array_equal(a.objects.numpy(), np.asarray(b.objects))
    traced, ref_traced = port.get_paths(1), ref.get_paths(1)
    pairs = list(zip(traced, ref_traced, strict=True))
    assert len(pairs) == int(traced.mask.sum()) > 0
    for a, b in pairs:
        np.testing.assert_array_equal(a.vertices.numpy(), np.asarray(b.vertices))
        np.testing.assert_array_equal(a.interaction_types.numpy(), np.asarray(b.interaction_types))


def test_squeeze_matches_jax() -> None:
    port, ref = launched()
    one = port.reshape(1, 6, 1).get_paths(2)
    ref_one = ref.reshape(1, 6, 1).get_paths(2)
    for axis in (None, 0, (0, 2), -1):
        got, want = one.squeeze(axis), ref_one.squeeze(axis)
        assert got.shape == tuple(want.shape)
        np.testing.assert_array_equal(got.vertices.numpy(), np.asarray(want.vertices))
    with pytest.raises(ValueError, match="extent"):
        one.squeeze(1)


def test_launched_paths_plot_every_order_as_jax_does() -> None:
    port, ref = launched()
    assert_lines_equal(lines(port.plot(backend="matplotlib")), lines(ref.plot(backend="matplotlib")))


@pytest.mark.parametrize(("alias", "jax_alias"), [(Paths, "Paths"), (SBRPaths, "SBRPaths")])
def test_deprecated_aliases_warn_as_jax_does(alias, jax_alias) -> None:
    import differt_tpu.geometry._paths as jax_paths

    port, ref = launched()
    base = port.get_paths(1) if alias is Paths else port
    ref_base = ref.get_paths(1) if alias is Paths else ref
    fields = {k: getattr(base, k) for k in ("vertices", "objects", "interaction_types")}
    ref_fields = {k: getattr(ref_base, k) for k in ("vertices", "objects", "interaction_types")}
    mask_name = "mask" if alias is Paths else "masks"
    with pytest.warns(DeprecationWarning) as got:
        made = alias(**fields, **{mask_name: getattr(base, mask_name)})
    with pytest.warns(DeprecationWarning) as want:
        getattr(jax_paths, jax_alias)(**ref_fields, **{mask_name: getattr(ref_base, mask_name)})
    assert str(got[0].message) == str(want[0].message)
    assert isinstance(made, TracedPaths if alias is Paths else LaunchedPaths)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        type(base)(**fields, **{mask_name: getattr(base, mask_name)})  # the new names do not warn


@pytest.mark.parametrize("kind", ["antenna", "pattern"])
def test_plot_radiation_pattern_matches_jax(kind: str) -> None:
    if kind == "antenna":
        ref = JaxDipole(jnp.asarray(2.4e9), center=jnp.array([0.5, 0.0, 1.0]))
        port = to_torch_antenna(ref)
        kw = {"num_points": 12, "num_wavelengths": 4.0}
    else:
        port = HWDipolePattern(2.4e9, direction=(0.0, 0.0, 1.0), center=(0.0, 0.0, 0.0), device="cpu")
        ref = JaxHWDipolePattern(jnp.asarray(2.4e9), direction=jnp.array([0.0, 0.0, 1.0]), center=jnp.zeros(3))
        kw = {"num_points": 12}
    got, want = port.plot_radiation_pattern(**kw), ref.plot_radiation_pattern(**kw)
    assert polygons(got).shape == polygons(want).shape
    np.testing.assert_allclose(polygons(got), polygons(want), rtol=1e-5, atol=1e-5)


def test_plotly_draws() -> None:
    pytest.importorskip("plotly")
    fig = plotting.draw_markers(torch.zeros((2, 3)), labels=["tx", "rx"], backend="plotly")
    assert len(fig.data) == 1


class TestVispyBackend:
    def test_vispy_is_a_supported_backend(self) -> None:
        from differt_tpu_torch.plotting import _utils

        assert "vispy" in _utils.SUPPORTED_BACKENDS
        assert _utils.get_backend("vispy") == "vispy"

    def test_vispy_without_package_raises_import_error(self) -> None:
        import importlib.util

        if importlib.util.find_spec("vispy") is not None:
            pytest.skip("vispy installed; covered by test_vispy_draws")
        with pytest.raises(ImportError):
            plotting.draw_markers(torch.zeros((1, 3)), backend="vispy")

    def test_vispy_draws(self) -> None:
        pytest.importorskip("vispy")
        with plotting.reuse(backend="vispy") as canvas:
            plotting.draw_mesh(Mesh.box(1.0, 1.0, 1.0, device="cpu"))
            plotting.draw_paths(torch.zeros((2, 3, 3)))
            plotting.draw_markers(torch.zeros((1, 3)), labels=["tx"])
        assert canvas is not None
