"""Build and load the hand-written Hopper kernels at first use.

The CUDA sources in ``differt_tpu_torch/csrc/`` are compiled with ``nvcc``
into one shared library with a plain C interface under ``build/kernels/``
at the repository root (the file name carries a hash of the sources and
flags, so an edited source rebuilds), then bound through :mod:`ctypes`.
Nothing is built when the package is imported.

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
SOURCES = ("anyhit.cu", "closest.cu", "trace.cu")
HEADERS = ("mt.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of csrc/*.cu (every pointer, and the stream, as c_void_p).
_SIGNATURES = {
    "differt_anyhit": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _P, _P),
    "differt_closest": (_P, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P),
    "differt_trace": (
        (_P,) * 7 + (_I,) * 6 + (_F,) * 4 + (_P, _P, _P)
    ),
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


@functools.cache
def load_kernels() -> ctypes.CDLL:
    """Compile the kernels if needed, load them and declare their C signatures."""
    path = library_path()
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [
            _nvcc(),
            *NVCC_FLAGS,
            f"-I{CSRC}",
            "-o",
            str(tmp),
            *(str(CSRC / name) for name in SOURCES),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            msg = f"Kernel build failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}"
            raise RuntimeError(msg)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(name: str, status: int) -> None:
    """Raise if a kernel launch reported a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        msg = f"{name}: CUDA launch failed with cudaError_t {status}."
        raise RuntimeError(msg)
