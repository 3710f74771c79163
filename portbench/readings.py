"""The readings that the limits of ``portbench/limits/`` are set from, on the card, at a cell's own size.

    python3 portbench/readings.py --workload NAME --seeds 1,2,3 [--control-seeds 4,5,6] [--fault-seeds 7,8,9]
        [--window-steps 8]

One set-up for every seed. For each of ``--seeds`` the cell's call runs
as a run makes it (a map on the seed's first inputs, or the checked steps
of a placement cell and then ``--window-steps`` steps as its window takes
them) and is compared with the plain reference: the lower readings. For
each of ``--control-seeds`` the reference computed in bfloat16 takes the
program's place (the control): the upper readings. For each of
``--fault-seeds`` (placement cells) the program runs with half of the
receivers left out, the mean taken over the rest. One JSON line a seed,
then one of the largest sound reading and the smallest control and fault
reading of each number. The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def control_numbers(entry, dtype, window_steps: int = 1) -> dict:
    """The reference in ``dtype`` in the program's place, against the reference in float32.

    For a placement cell the control takes the checked steps and then
    ``window_steps`` steps, each of these as the window's output (loss, TX, permittivity).
    """
    from portbench.entries.coverage_map import db_gap

    if entry.unit == "map":
        return {"map_db_gap": db_gap(entry.reference_map(0, dtype), entry.reference_map(0))}
    checked = entry.traffic["checked_steps"]
    taken = entry.reference_steps(dtype, checked + window_steps)
    entry.history = [(tx, eta, entry.start[0].new_tensor([loss])) for tx, eta, loss in taken[:checked]]
    outputs = [
        torch.cat((entry.start[0].new_tensor([loss]), tx.float().reshape(-1), eta.float().reshape(-1)))
        for tx, eta, loss in taken[checked:]
    ]
    return entry.compare(outputs)


def steps(entry, window_steps: int) -> list:
    """The checked steps (into ``entry.history``), then ``window_steps`` more as a window takes them."""
    entry.warm()
    first = len(entry.history)
    return [entry.call(first + i) for i in range(window_steps)]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=seeds, default=[])
    parser.add_argument("--control-seeds", type=seeds, default=[])
    parser.add_argument("--fault-seeds", type=seeds, default=[])
    parser.add_argument("--window-steps", type=int, default=8, help="a placement cell's steps after the checked ones")
    args = parser.parse_args()
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(ROOT / "build" / "portbench" / "torch_kernels")
    sys.path.insert(0, str(ROOT))

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench needs a CUDA card, and none is visible", file=sys.stderr)
        return 4
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    files = harness.cell_files(args.workload)
    files["traffic"]["inputs"] = 1
    entry = harness.make_entry(files, device)
    first = (args.seeds + args.control_seeds + args.fault_seeds)[0]
    entry.setup(first)
    worst, least = {}, {}

    def report(kind: str, seed: int, numbers: dict, seconds: float) -> None:
        print(json.dumps({"kind": kind, "seed": seed, "seconds": seconds, **numbers}), flush=True)
        table = worst if kind == "program" else least
        pick = max if kind == "program" else min
        for name, value in numbers.items():
            if name in files["limits"]["compare"]:
                table.setdefault(kind, {})[name] = pick(table.get(kind, {}).get(name, value), value)

    for seed in args.seeds:
        start = time.perf_counter()
        entry.draw(seed)
        if entry.unit == "map":
            out = entry.call(0)
            torch.cuda.synchronize()
            numbers = entry.compare([out])
        else:
            numbers = entry.compare(steps(entry, args.window_steps))
        report("program", seed, numbers, time.perf_counter() - start)
    for seed in args.control_seeds:
        start = time.perf_counter()
        entry.draw(seed)
        report("control", seed, control_numbers(entry, torch.bfloat16, args.window_steps), time.perf_counter() - start)
    for seed in args.fault_seeds:
        start = time.perf_counter()
        entry.draw(seed)
        whole, scene = entry.rx, entry.scene
        entry.rx = whole[::2].contiguous()
        entry.scene = type(scene)(transmitters=scene.transmitters, receivers=entry.rx, mesh=entry.mesh)
        outputs = steps(entry, args.window_steps)
        entry.rx, entry.scene = whole, scene
        report("fault_half_batch", seed, entry.compare(outputs), time.perf_counter() - start)
    print(json.dumps({"largest_sound": worst.get("program", {}), "smallest_control": least.get("control", {}),
                      "smallest_fault": least.get("fault_half_batch", {})}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
