"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. Set-up makes the cell's city and inputs from
the seed, builds the port's kernels if needed (into ``build/`` inside the
checkout) and warms up on the cell's own shapes; then whole calls run back
to back for ``--seconds`` (``--trace 0``: the end-to-end metrics) or the
cell's traced calls run under the profiler (``--trace 1``: the per-layer
metrics). The outputs are compared with the plain reference of
``portbench/reference/``. The last line of standard output is one JSON
object; the numbers compared, each with its limit, end standard error.
Prints no result and exits with 2 for a workload ``BENCHMARK.json`` does
not name, with 4 without the CUDA cards the cell asks for, and with 5 when
a module of JAX or of the JAX package is loaded, or the trace cannot be read.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()

    # Kernel caches of PyTorch and its compilers, at fixed paths inside the checkout.
    for var, sub in (
        ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
        ("CUDA_CACHE_PATH", "cuda_compute_cache"),
        ("TRITON_CACHE_DIR", "triton"),
        ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
    ):
        os.environ[var] = str(CACHE / sub)
        (CACHE / sub).mkdir(parents=True, exist_ok=True)
    # One host thread for PyTorch's CPU work: the load of one process with
    # few threads, on a host whose cores other machines' work shares.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))

    import torch

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload named {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench's {args.workload} needs {chips} CUDA card(s), and fewer are visible", file=sys.stderr)
        return 4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from portbench import harness

    result, checks = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), STARTED)
    if result is None:
        return 5
    print(json.dumps(result), flush=True)
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
