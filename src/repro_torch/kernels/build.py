"""Build and load the port's CUDA kernels (``csrc/*.cu``) on first use.

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface and loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  Libraries land in ``_build/`` beside
this package (listed in ``.gitignore``), named by a hash of the source and
the flags, so an edited source is never served a stale library.  Nothing
is built at import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: name -> (loaded library, seconds the build took, nvcc's log)
_LIBS: dict = {}
_LOCK = threading.Lock()

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
#: C signature of every entry point: (argtypes, restype)
SIGNATURES = {
    "wire_kernels": {
        "repro_topk_encode": ([_P, _P, _P, _P, _P, _LL, _LL, _P], ctypes.c_int),
        "repro_absmax": ([_P, _P, _LL, _LL, _P], ctypes.c_int),
        "repro_quant_dequant": ([_P, _P, _P, _LL, _LL, _P], ctypes.c_int),
    },
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are compiled on first use"
    )


def _compile(name: str) -> tuple[Path, float, str]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
    log.write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds, proc.stderr


def library(name: str = "wire_kernels"):
    """The loaded ``ctypes`` library for ``csrc/<name>.cu``, built on the
    first call in this process (or reused from ``_build/``)."""
    with _LOCK:
        if name not in _LIBS:
            path, seconds, log = _compile(name)
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIBS[name] = (lib, seconds, log)
        return _LIBS[name][0]


def build_info(name: str = "wire_kernels") -> dict:
    """Seconds the build of ``name`` took in this process (0.0 when a
    library was reused) and nvcc's ``-Xptxas -v`` report."""
    library(name)
    _, seconds, log = _LIBS[name]
    return {"seconds": seconds, "log": log}


def check_rows(x, what: str) -> None:
    """Validate a kernel operand: a contiguous, 16-byte aligned f32 matrix
    on a CUDA device with 1..65535 rows (grid.y) of at least one element."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous (rows, n) matrix")
    if not (1 <= x.shape[0] <= 65535 and x.shape[1] >= 1):
        raise ValueError(f"{what}: unsupported shape {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: base pointer is not 16-byte aligned")


def check_vector(v, what: str, x) -> None:
    """Validate a per-row f32 operand (threshold, scale) beside ``x``."""
    if not (
        isinstance(v, torch.Tensor) and v.device == x.device
        and v.dtype == torch.float32 and v.shape == (x.shape[0],)
        and v.is_contiguous()
    ):
        raise ValueError(
            f"{what}: expected a contiguous float32 ({x.shape[0]},) tensor "
            f"on {x.device}"
        )


def stream_of(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def check(status: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
