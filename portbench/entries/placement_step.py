"""Entry ``placement_step``: one ``streamed_placement_step`` a call, each from the last one's TX and permittivity.

Traffic keys: ``receivers``, ``orders`` (candidate sets, see
:func:`portbench.inputs.candidate_set`), ``candidate_chunk``,
``rx_chunk``, ``tx_learning_rate``, ``eta_learning_rate``,
``tx_jitter_m`` (the start TX is the configuration's moved in x and y by
up to this), ``checked_steps`` (the first steps, taken in set-up through
the window's own call and held against the reference, with the change
over all of them) and ``traced_calls``. Every step of the window is held
against the reference too, at the state it started from. The loss is the step's own: the negated mean dB power
over the grid.
"""

import statistics

import numpy as np
import torch

from .. import bounds, inputs
from ..reference import coverage as ref_coverage
from ..reference import trace as ref_trace

NOUGHT = 1e-3  # a leaf whose reference gradient is below this share of the median leaf's is left out


def norm_gap(program: dict, reference: dict) -> float:
    """Worst leaf's | |program| - |reference| | over the larger of its reference norm and the median leaf's.

    Where every reference norm is 0, a leaf that moves in the program reads 1.
    """
    norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in reference.items()}
    ours = {k: float(torch.linalg.vector_norm(v.double())) for k, v in program.items()}
    median = statistics.median(norms.values())
    if median == 0.0:
        return 1.0 if any(ours.values()) else 0.0
    gaps = [abs(ours[k] - n) / max(n, median) for k, n in norms.items() if n >= NOUGHT * median]
    return max(gaps) if gaps else 0.0


class Entry:
    unit = "step"

    def __init__(self, config: dict, traffic: dict, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.cities = {}  # the reference's own view of the city, by dtype, made at the first comparison

    def setup(self, seed: int) -> None:
        from differt_tpu_torch import interop
        from differt_tpu_torch.geometry import Scene

        self.arrays = inputs.city_arrays(self.config)
        self.mesh = interop.mesh_from_numpy(self.arrays, device=self.device)
        self.mesh.bvh
        self.num_primitives = self.arrays["triangles"].shape[0]
        self.tv = torch.from_numpy(self.arrays["vertices"][self.arrays["triangles"]]).to(self.device)
        self.rx = inputs.receiver_points(self.config["grids"][self.traffic["receivers"]], self.config["tx"], self.device)
        self.scene = Scene(
            transmitters=torch.tensor([self.config["tx"]], device=self.device), receivers=self.rx, mesh=self.mesh
        )
        self.conductivity = torch.tensor([self.config["conductivity"]], device=self.device)
        self.draw(seed)

    def draw(self, seed: int) -> None:
        rng = np.random.default_rng(seed)
        tx = inputs.draw_tx(self.config, self.traffic["tx_jitter_m"], rng)
        city = inputs.city(self, tx)
        self.sets = [inputs.candidate_set(o["candidates"], o["order"], city, rng) for o in self.traffic["orders"]]
        self.start = (torch.tensor([tx], device=self.device), torch.tensor([self.config["eta_r"]], device=self.device))
        self.state = self.start
        self.history = []  # (tx, eta_r, loss) after each checked step

    def warm(self) -> None:
        """The checked steps: the first steps of the run, through the window's call."""
        for i in range(self.traffic["checked_steps"]):
            loss = self.call(i)
            self.history.append((*self.state, loss))

    def call(self, i: int) -> torch.Tensor:
        from differt_tpu_torch.parallel import streamed_placement_step

        tx, eta_r = self.state
        new_tx, new_eta, loss = streamed_placement_step(
            self.scene,
            self.config["frequency_hz"],
            None,
            tx=tx,
            eta_r=eta_r,
            conductivity=self.conductivity,
            path_candidates=self.sets,
            candidate_chunk=self.traffic["candidate_chunk"],
            rx_chunk=self.traffic["rx_chunk"],
            tx_learning_rate=self.traffic["tx_learning_rate"],
            eta_learning_rate=self.traffic["eta_learning_rate"],
        )
        self.state = (new_tx, new_eta)
        return torch.cat((loss.reshape(1), new_tx.reshape(-1), new_eta.reshape(-1)))

    def finite(self, out: torch.Tensor) -> bool:
        return bool(torch.isfinite(out).all())

    def reference_city(self, dtype=torch.float32) -> ref_trace.City:
        if dtype not in self.cities:
            self.cities[dtype] = ref_trace.City(
                torch.from_numpy(self.arrays["vertices"]).to(self.device),
                torch.from_numpy(self.arrays["triangles"]).to(self.device),
                dtype=dtype,
            )
        return self.cities[dtype]

    def reference_steps(self, dtype=torch.float32, steps: int | None = None) -> list:
        """The reference's own first ``steps`` steps (the checked steps by default) from the start,
        in ``dtype``: ``(tx, eta_r, loss)`` after each."""
        return ref_coverage.placement_steps(
            self.reference_city(dtype), *self.start, self.conductivity, self.rx, self.sets,
            self.config["frequency_hz"], self.traffic["tx_learning_rate"], self.traffic["eta_learning_rate"],
            self.traffic["checked_steps"] if steps is None else steps,
        )

    def compare_history(self, history) -> dict:
        """The numbers compared: each step of ``history`` (``(tx, eta_r, loss)`` after it) against the
        reference evaluated at the state that step started from.

        The reference follows the program's own states: two runs of hard
        masks that start a later step a rounding apart can differ there by
        a path on the edge of validity, which says nothing of either step.
        """
        lr = {"tx": self.traffic["tx_learning_rate"], "eta_r": self.traffic["eta_learning_rate"]}
        states = [self.start] + [(h[0], h[1]) for h in history[:-1]]
        city = self.reference_city()
        reference = [
            ref_coverage.placement_gradient(city, tx, eta_r, self.conductivity, self.rx, self.sets, self.config["frequency_hz"])
            for tx, eta_r in states
        ]
        x0 = dict(zip(("tx", "eta_r"), self.start, strict=True))
        x1 = {"tx": history[0][0], "eta_r": history[0][1]}
        xn = {"tx": history[-1][0], "eta_r": history[-1][1]}
        loss_gap = max(
            abs(float(h[2].reshape(-1)[0]) - r[0]) / abs(r[0]) for h, r in zip(history, reference, strict=True)
        )
        change_reference = {
            "tx": -lr["tx"] * sum(r[1] for r in reference),
            "eta_r": -lr["eta_r"] * sum(r[2] for r in reference),
        }
        return {
            "step_loss_gap": loss_gap,
            "step_grad_gap": norm_gap(
                {k: (x0[k] - x1[k]) / lr[k] for k in x0}, {"tx": reference[0][1], "eta_r": reference[0][2]}
            ),
            "step_change_gap": norm_gap({k: xn[k] - x0[k] for k in x0}, change_reference),
        }

    def compare_window(self, outputs: list[torch.Tensor]) -> dict:
        """The numbers compared on the window's steps, each one: its loss, and its update
        over the learning rates as the gradient, against the reference at the
        state it started from (the previous step's output; the first from the
        last checked step's)."""
        lr = {"tx": self.traffic["tx_learning_rate"], "eta_r": self.traffic["eta_learning_rate"]}
        city = self.reference_city()
        before = dict(zip(("tx", "eta_r"), self.history[-1][:2] if self.history else self.start, strict=True))
        loss_gaps, grad_gaps = [], []
        for out in outputs:
            after = {"tx": out[1:4].reshape(1, 3), "eta_r": out[4:5]}
            loss, g_tx, g_eta = ref_coverage.placement_gradient(
                city, before["tx"], before["eta_r"], self.conductivity, self.rx, self.sets, self.config["frequency_hz"]
            )
            loss_gaps.append(abs(float(out[0]) - loss) / abs(loss))
            grad_gaps.append(
                norm_gap({k: (before[k] - after[k]) / lr[k] for k in lr}, {"tx": g_tx, "eta_r": g_eta})
            )
            before = after
        return {
            "window_loss_gap": max(loss_gaps, default=0.0),
            "window_grad_gap": max(grad_gaps, default=0.0),
            "window_steps_checked": len(outputs),
        }

    def compare(self, outputs: list[torch.Tensor]) -> dict:
        """The checked steps' numbers (:meth:`compare_history`) and the window's (:meth:`compare_window`)."""
        return {**self.compare_history(self.history), **self.compare_window(outputs)}

    def bounds_s(self, num_calls: int) -> dict:
        num_rx = self.rx.shape[0]
        rx_tile = min(self.traffic["rx_chunk"], num_rx)
        rx_tiles = -(-num_rx // rx_tile)
        total = 0.0
        for spec, cands in zip(self.traffic["orders"], self.sets, strict=True):
            chunk = min(self.traffic["candidate_chunk"], cands.shape[0])
            tiles = rx_tiles * -(-cands.shape[0] // chunk)
            total += tiles * bounds.trace_launch_s(1, chunk, rx_tile, spec["order"], self.num_primitives)
        return {"trace": 2 * total * num_calls}  # the forward pass and the backward pass each launch a tile once
