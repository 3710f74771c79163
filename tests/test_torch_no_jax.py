"""The port imports and runs with JAX made unimportable."""

import subprocess
import sys
from pathlib import Path

_PROGRAM = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
for backend in ("matplotlib", "plotly", "vispy"):  # a GPU host may have no plotting backend
    sys.modules[backend] = None
import torch
torch.set_num_threads(1)
import differt_tpu_torch
from differt_tpu_torch.coverage import power_map, power_map_chunked
from differt_tpu_torch.em import HWDipolePattern
from differt_tpu_torch.geometry import Scene, generate_path_candidates
from differt_tpu_torch.parallel import placement_training_step, streamed_placement_step
from differt_tpu_torch.scenes import street_canyon_scene

scene = Scene(
    transmitters=torch.tensor([[-30.0, 0.0, 20.0]]), mesh=street_canyon_scene(device="cpu").mesh
).with_receivers_grid(8, 8)
power = power_map(scene, 2.4e9, order=1)
assert power.shape == (1, 8, 8), power.shape
assert bool(torch.isfinite(power).all()) and float(power.max()) > 0.0
paths = scene.launch_paths(order=2, num_rays=2000, max_dist=4.0)
assert paths.masks.shape == (1, 8, 8, 2000, 3) and bool(paths.masks.any())
diffraction = power_map(scene, 2.4e9, order=1, with_diffraction=True)
assert diffraction.shape == (1, 8, 8) and bool(torch.isfinite(diffraction).all()) and bool((diffraction != power).any())
mixed = scene.trace_mixed_paths((0, 1))
assert mixed.shape[:2] == (1, 64) and mixed.order == 2 and bool(mixed.mask.any())
scattered = scene.trace_scattering_paths()
assert scattered.shape == (1, 64, scene.mesh.num_triangles) and bool(scattered.mask.any())
with_mixed = power_map(scene, 2.4e9, order=1, mixed_signatures=[(0, 1), (1, 0)])
assert with_mixed.shape == (1, 8, 8) and bool(torch.isfinite(with_mixed).all()) and bool((with_mixed != power).any())
with_scattering = power_map(scene, 2.4e9, order=1, with_scattering=True, scattering_coefficient=0.3)
assert with_scattering.shape == (1, 8, 8) and bool(torch.isfinite(with_scattering).all()) and bool((with_scattering != power).any())
hybrid = power_map(scene, 2.4e9, order=1, solver="hybrid", num_rays=2000)
assert hybrid.shape == (1, 8, 8) and bool(torch.isfinite(hybrid).all()) and float(hybrid.max()) > 0.0
pattern = HWDipolePattern(2.4e9, direction=(0.0, 0.0, 1.0), center=scene.transmitters[0])
dipole = power_map_chunked(scene, 2.4e9, order=1, tx_pattern=pattern, candidate_chunk=16, rx_chunk=32)
assert dipole.shape == (1, 8, 8) and bool(torch.isfinite(dipole).all()) and float(dipole.max()) > 0.0
merged = scene.trace_paths(order=[0, 1], merge_orders=True)
assert merged.order == 1 and merged.shape == (1, 8, 8, 1 + scene.mesh.num_triangles)
mlm = scene.compute_tx_mlm(num_rays=2000, order=2, grid_size=(16, 16), receiver_plane_z=1.5)
assert mlm.shape == (1, 16, 16) and len(torch.unique(mlm)) > 3
candidates = [generate_path_candidates(scene.mesh.num_triangles, o, device="cpu")[:40] for o in (1, 2)]
tx0 = scene.transmitters
materials = {"eta_r": torch.tensor([5.24]), "conductivity": torch.tensor([0.1])}
for smoothing_factor in (None, 50.0):
    tx, eta, loss = streamed_placement_step(
        scene, 2.4e9, tx=tx0, path_candidates=candidates, candidate_chunk=16, rx_chunk=24,
        smoothing_factor=smoothing_factor, **materials,
    )
    assert bool(torch.isfinite(loss)) and bool((tx != tx0).any()) and bool(torch.isfinite(tx).all())
tx, eta, loss = placement_training_step(scene, 2.4e9, order=1, tx=tx0, **materials)
assert bool(torch.isfinite(loss)) and bool((tx != tx0).any()) and bool((eta != 5.24).all())
import tempfile
from pathlib import Path
from differt_tpu_torch import io
from differt_tpu_torch.plugins import deepmimo
with tempfile.TemporaryDirectory() as folder:
    obj = Path(folder) / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 4 3\n")
    assert io.load_obj(obj, device="cpu").num_triangles == 2
    loaded = Scene.load_xml(io.export_scene_xml(scene.mesh, folder), device="cpu")
assert torch.equal(loaded.mesh.triangle_vertices, scene.mesh.triangle_vertices)
import contextlib
import io as text_io
from differt_tpu_torch.io import _sionna
from differt_tpu_torch.io.__main__ import main as sionna_main
with tempfile.TemporaryDirectory() as folder:
    (Path(folder) / "demo").mkdir()
    (Path(folder) / "demo" / "demo.xml").write_text("<scene version='2.1.0'></scene>")
    printed = text_io.StringIO()
    with contextlib.redirect_stdout(printed):
        assert sionna_main(["list", "--folder", folder]) == 0
    assert printed.getvalue() == "demo\n" and _sionna.list_sionna_scenes(folder) == ["demo"]
loaded = Scene(transmitters=scene.transmitters, receivers=scene.receivers, mesh=loaded.mesh)
channels = deepmimo.export(paths=[loaded.trace_paths(order=o) for o in (0, 1)], scene=loaded, frequency=2.4e9)
assert channels.power.shape == (1, 64, 1 + loaded.mesh.num_triangles) and bool(torch.isfinite(channels.power[channels.mask]).all())
import torch.distributed as dist
from differt_tpu_torch import parallel, plotting, profiling
mesh = parallel.make_device_mesh(1, device="cpu")
sharded = parallel.sharded_power_map(scene, 2.4e9, mesh, order=1)
dist.destroy_process_group()
assert torch.equal(sharded, power)
assert sorted(profiling.timeit(lambda: power.sum(), repeats=2)) == ["max", "mean", "min", "repeats"]
try:
    scene.plot(backend="matplotlib")
except ImportError:
    pass
else:
    raise AssertionError("drawing without matplotlib should raise ImportError")
import importlib.util
from differt_tpu_torch import treekit
with tempfile.TemporaryDirectory() as folder:
    treekit.tree_serialise_leaves(Path(folder) / "ckpt", scene)
    back = treekit.tree_deserialise_leaves(Path(folder) / "ckpt", scene)
assert torch.equal(back.mesh.vertices, scene.mesh.vertices) and back.mesh._bvh is None
for name, kw in (
    ("torch_two_ray_model", {"distances": (30.0,)}),
    ("torch_coverage_map", {"grid": 4, "steps": 1}),
    ("torch_propagation_mechanisms", {}),
    ("torch_multichip_sharding", {"grid": 4, "steps": 1}),
):
    spec = importlib.util.spec_from_file_location(name, Path("examples") / f"{name}.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(device="cpu", **kw)
assert not any(name == "jax" or name.startswith(("jax.", "differt_tpu.")) for name in sys.modules if sys.modules[name] is not None)
print("ok")
"""


def test_port_runs_without_jax() -> None:
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _PROGRAM],
        cwd=root,
        capture_output=True,
        text=True,
        timeout=300,
        check=False,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
