"""Build and load the hand-written Hopper kernels at first use.

The CUDA sources in ``differt_tpu_torch/csrc/`` are compiled with ``nvcc``,
one process per source, all started together, then linked into one shared
library with a plain C interface under ``build/kernels/`` at the
repository root (the file name carries a hash of the sources and flags,
so an edited source rebuilds), and bound through :mod:`ctypes`. What
``ptxas`` reports for each kernel (registers, spills, shared memory) is
kept beside the library (:func:`ptxas_report`). Nothing is built when the
package is imported.

``--fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions and the JAX reference compute them: contracted
FMAs move float32 rounding and flip borderline hit tests.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("anyhit.cu", "closest.cu", "em.cu", "trace.cu")
HEADERS = ("mt.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of csrc/*.cu (every pointer, and the stream, as c_void_p).
_SIGNATURES = {
    "differt_anyhit": (_P,) * 5 + (_I,) * 6 + (_F, _P, _P, _P),
    "differt_closest": (_P,) * 4 + (_I,) * 4 + (_F, _P, _P, _P),
    "differt_lattice_closest": (_P,) * 3 + (_I,) * 2 + (_P,) * 2 + (_I,) * 3 + (_F, _P, _I, _P, _P, _P),
    "differt_em": (_P,) * 7 + (_I, _P) + (_I,) * 4 + (_L,) * 6 + (_I, _P, _P, _P),
    "differt_em_splits": (_I,) * 3,
    "differt_trace": (_P,) * 6 + (_I,) * 8 + (_F,) * 4 + (_P, _P, _P),
    "differt_trace_max_order": (),
}


def _nvcc() -> str:
    candidates = []
    if cuda_home := os.environ.get("CUDA_HOME"):
        candidates.append(str(Path(cuda_home) / "bin" / "nvcc"))
    if found := shutil.which("nvcc"):
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if Path(path).is_file():
            return path
    msg = "nvcc was not found (set CUDA_HOME or put nvcc on PATH)."
    raise RuntimeError(msg)


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libdiffert_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands in parallel; raise with their output if one fails."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs, strict=True):
        if proc.returncode != 0:
            msg = f"Kernel build failed ({' '.join(cmd)}):\n{out}"
            raise RuntimeError(msg)
    return outputs


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Compile the kernels if needed, load them and declare their C signatures."""
    path = library_path()
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        stem = f"{path.stem}.{os.getpid()}"
        nvcc = _nvcc()
        objects = [BUILD_DIR / f"{stem}.{name}.o" for name in SOURCES]
        reports = _run([
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", f"-I{CSRC}", "-c", str(CSRC / name), "-o", str(obj)]
            for name, obj in zip(SOURCES, objects, strict=True)
        ])
        tmp = path.with_name(f"{stem}.tmp")
        try:
            _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]])
            path.with_suffix(".ptxas.txt").write_text("".join(reports))
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
            for obj in objects:
                obj.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def ptxas_report() -> str:
    """What ``ptxas -v`` said when the current library was built (empty if not built)."""
    report = library_path().with_suffix(".ptxas.txt")
    return report.read_text() if report.is_file() else ""


def check_launch(name: str, status: int) -> None:
    """Raise if a kernel launch reported a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        msg = f"{name}: CUDA launch failed with cudaError_t {status}."
        raise RuntimeError(msg)
