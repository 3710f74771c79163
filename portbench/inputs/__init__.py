"""The general generator: a configuration file and a traffic file to the inputs of each call.

Everything is made from the configuration (the scene, the materials, the
frequency, the nominal TX) and the run's ``--seed`` (each call's TX and
candidate shard), by the frozen copies in :mod:`portbench.reference`;
nothing is chosen by tracing with the port. Each kind of input is a
module of its own, found by the name that the files give:

- ``scenes/<config["scene"]>.py``: ``build(config) -> arrays`` (vertices, triangles);
- ``receivers/<spec["kind"]>.py``: ``make(spec, center, device) -> [R, 3]``;
- ``candidates/<spec["kind"]>.py``: ``make(spec, order, city, rng) -> [C, order]``
  int64, or ``None`` for the solver's own candidates;
- ``solvers/<spec["kind"]>.py``: ``make(spec)``, the port's solver that
  picks candidates (a traffic file without ``solver`` takes the exhaustive one).

A new scene, receiver layout or candidate kind is a new file there.
"""

import importlib

import numpy as np
import torch


def kind(family: str, name: str):
    """The module ``portbench/inputs/<family>/<name>.py``."""
    return importlib.import_module(f"{__name__}.{family}.{name}")


def city_arrays(config: dict) -> dict:
    """The configuration's scene as NumPy arrays, one material on every face."""
    arrays = kind("scenes", config["scene"]).build(config)
    num = arrays["triangles"].shape[0]
    if num != config["num_triangles"]:
        msg = f"the scene has {num} triangles, its configuration says {config['num_triangles']}"
        raise ValueError(msg)
    arrays["material_names"] = [config["material"]]
    arrays["face_materials"] = np.zeros(num, dtype=np.int64)
    return arrays


def receiver_points(spec: dict, center, device) -> torch.Tensor:
    """``[R, 3]`` float32 receivers of one of the configuration's ``grids``."""
    return kind("receivers", spec["kind"]).make(spec, center, device)


def solver(spec: dict | None):
    """The port's solver of a traffic file's ``solver``, or ``"exhaustive"``."""
    return "exhaustive" if spec is None else kind("solvers", spec["kind"]).make(spec)


def draw_tx(config: dict, jitter_m: float, rng: np.random.Generator) -> list[float]:
    """The nominal TX moved in x and y by up to ``jitter_m`` either way."""
    x, y, z = config["tx"]
    dx, dy = rng.uniform(-jitter_m, jitter_m, 2)
    return [float(x + dx), float(y + dy), float(z)]


def city(entry, tx) -> dict:
    """What a candidate kind may read: an entry's ``num_primitives``, its
    ``tv`` (``[T, 3, 3]`` on the device) as ``triangle_vertices``, its
    ``config`` and ``device``, and this call's ``tx``."""
    return {
        "num_primitives": entry.num_primitives,
        "triangle_vertices": entry.tv,
        "tx": tx,
        "config": entry.config,
        "device": entry.device,
    }


def candidate_set(spec: dict, order: int, city: dict, rng: np.random.Generator):
    """``[C, order]`` int64 candidates of one order (``city`` from :func:`city`), or ``None`` for the solver's own."""
    return kind("candidates", spec["kind"]).make(spec, order, city, rng)
