"""Entry ``coverage_map``: one coverage map a call, ``power_map_chunked`` once per order, the powers added.

Traffic keys: ``receivers`` (see :func:`portbench.inputs.receiver_points`),
``orders`` (each ``{"order": k, "candidates": {...}}``, see
:func:`portbench.inputs.candidate_set`; ``{"kind": "solver"}`` with a
``solver`` (:func:`portbench.inputs.solver`, e.g. ``{"kind": "hybrid",
"num_rays": n}``) lets the solver choose, and the reference then takes
every candidate of the order),
``candidate_chunk``, ``rx_chunk``, ``tx_jitter_m`` (each call's TX is the
configuration's moved in x and y by up to this), ``inputs`` (how many
calls' inputs are drawn in set-up; the window cycles through them),
``checked_calls`` (how many of the window's maps the reference recomputes,
drawn from the seed; 0 means all) and ``traced_calls``.
"""

import numpy as np
import torch

from .. import bounds, inputs
from ..reference import candidates as rc
from ..reference import coverage as ref_coverage
from ..reference import trace as ref_trace

LIT_WINDOW_DB = 40.0  # pixels within this of the reference's brightest are compared
GAP_CAP_DB = 300.0  # a pixel lit on one side only reads this
VISIBILITY_RAYS = 1 << 25  # rays a closest.cu launch of the visibility takes (ops/_dispatch.py, frozen)


def db_gap(port: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest |dB| difference over the pixels that either side lights within
    :data:`LIT_WINDOW_DB` of the reference's brightest."""
    port, ref = port.double().cpu(), ref.double().cpu()
    top = float(ref.max())
    if top <= 0.0:
        return 0.0 if float(port.max()) <= 0.0 else GAP_CAP_DB
    floor = top * 10.0 ** (-LIT_WINDOW_DB / 10.0)
    lit = (ref >= floor) | (port >= floor)
    ratio = port[lit].clamp(min=1e-300) / ref[lit].clamp(min=1e-300)
    return float(torch.clamp((10.0 * torch.log10(ratio)).abs(), max=GAP_CAP_DB).max())


class Entry:
    unit = "map"

    def __init__(self, config: dict, traffic: dict, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.cities = {}  # the reference's own view of the city, by dtype, made at the first comparison

    def setup(self, seed: int) -> None:
        """The city, its BVH, the receivers and the solver; then the inputs of ``seed``."""
        from differt_tpu_torch import interop

        self.arrays = inputs.city_arrays(self.config)
        self.mesh = interop.mesh_from_numpy(self.arrays, device=self.device)
        self.mesh.bvh  # built once, here
        self.num_primitives = self.arrays["triangles"].shape[0]
        self.tv = torch.from_numpy(self.arrays["vertices"][self.arrays["triangles"]]).to(self.device)
        self.rx = inputs.receiver_points(self.config["grids"][self.traffic["receivers"]], self.config["tx"], self.device)
        self.solver = inputs.solver(self.traffic.get("solver"))
        self.materials = {
            "eta_r": torch.tensor([self.config["eta_r"]], device=self.device),
            "conductivity": torch.tensor([self.config["conductivity"]], device=self.device),
        }
        self.draw(seed)

    def draw(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        self.inputs = []
        for _ in range(self.traffic["inputs"]):
            tx = inputs.draw_tx(self.config, self.traffic["tx_jitter_m"], rng)
            city = inputs.city(self, tx)
            sets = [inputs.candidate_set(o["candidates"], o["order"], city, rng) for o in self.traffic["orders"]]
            self.inputs.append((tx, sets))
        self.check_rng = rng

    def warm(self) -> None:
        self.call(0)

    def call(self, i: int) -> torch.Tensor:
        from differt_tpu_torch.coverage import power_map_chunked
        from differt_tpu_torch.geometry import Scene

        tx, sets = self.inputs[i % len(self.inputs)]
        scene = Scene(
            transmitters=torch.tensor([tx], device=self.device), receivers=self.rx, mesh=self.mesh
        )
        total = None
        for spec, cands in zip(self.traffic["orders"], sets, strict=True):
            power = power_map_chunked(
                scene,
                self.config["frequency_hz"],
                order=spec["order"],
                solver=self.solver,
                path_candidates=None if cands is None or cands.shape[1] == 0 else cands,
                candidate_chunk=self.traffic["candidate_chunk"],
                rx_chunk=self.traffic["rx_chunk"],
                **self.materials,
            ).reshape(-1)
            total = power if total is None else total + power
        return total

    def finite(self, out: torch.Tensor) -> bool:
        return bool(torch.isfinite(out).all())

    def reference_map(self, i: int, dtype=torch.float32) -> torch.Tensor:
        """The plain reference's map of call ``i``'s inputs, in ``dtype`` (the control: bfloat16)."""
        tx, sets = self.inputs[i % len(self.inputs)]
        if dtype not in self.cities:
            self.cities[dtype] = ref_trace.City(
                torch.from_numpy(self.arrays["vertices"]).to(self.device),
                torch.from_numpy(self.arrays["triangles"]).to(self.device),
                dtype=dtype,
            )
        city = self.cities[dtype]
        ref_sets = []
        for spec, cands in zip(self.traffic["orders"], sets, strict=True):
            if cands is None:  # the solver's own: the reference takes every candidate
                order = spec["order"]
                cands = rc.decode_range(0, rc.count(self.num_primitives, order), self.num_primitives, order, self.device)
            ref_sets.append(cands)
        return ref_coverage.power_map(
            city,
            torch.tensor([tx], device=self.device),
            self.rx,
            ref_sets,
            torch.tensor([self.config["eta_r"]], device=self.device),
            torch.tensor([self.config["conductivity"]], device=self.device),
            self.config["frequency_hz"],
        )

    def checked(self, num_calls: int) -> list[int]:
        """The calls of the window that the reference recomputes, drawn from the seed."""
        want = self.traffic["checked_calls"]
        if want <= 0 or want >= num_calls:
            return list(range(num_calls))
        return sorted(int(i) for i in self.check_rng.choice(num_calls, size=want, replace=False))

    def compare(self, outputs: list[torch.Tensor]) -> dict:
        """The numbers compared: the widest dB gap of the checked maps."""
        picks = self.checked(len(outputs))
        gap = max(db_gap(outputs[i], self.reference_map(i)) for i in picks)
        return {"map_db_gap": gap, "maps_checked": len(picks)}

    def bounds_s(self, num_calls: int) -> dict:
        """The kernels' bounds over ``num_calls`` calls, by counter."""
        out = {"trace": 0.0, "closest": 0.0}
        num_rx = self.rx.shape[0]
        rx_tile = min(self.traffic["rx_chunk"], num_rx)
        rx_tiles = -(-num_rx // rx_tile)
        tri = self.num_primitives
        for spec, cands in zip(self.traffic["orders"], self.inputs[0][1], strict=True):
            order = spec["order"]
            if cands is not None and order >= 1:
                chunk = min(self.traffic["candidate_chunk"], cands.shape[0])
                tiles = rx_tiles * -(-cands.shape[0] // chunk)
                out["trace"] += tiles * bounds.trace_launch_s(1, chunk, rx_tile, order, tri)
            if cands is None and self.traffic["solver"]["kind"] == "hybrid":
                # visibility: lattice rays from the TX, then from the receivers
                rays = self.traffic["solver"]["num_rays"]
                per = max(1, VISIBILITY_RAYS // rays)
                for vertices in (1, num_rx):
                    for lo in range(0, vertices, per):
                        out["closest"] += bounds.closest_launch_s(min(per, vertices - lo) * rays, tri)
        return {k: v * num_calls for k, v in out.items()}
