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
_I = ctypes.c_int
#: C signature of every entry point, by source: (argtypes, restype)
SIGNATURES = {
    "wire_kernels": {
        "repro_topk_encode": ([_P, _P, _P, _P, _P, _LL, _LL, _P], ctypes.c_int),
        "repro_absmax": ([_P, _P, _LL, _LL, _P], ctypes.c_int),
        "repro_quant_dequant": ([_P, _P, _P, _LL, _LL, _P], ctypes.c_int),
        "repro_int8_encode": ([_P, _P, _P, _P, _P, _P, _LL, _LL, _P], ctypes.c_int),
        "repro_int8_encode_one_launch_max": ([], ctypes.c_longlong),
    },
    "decode_attention": {
        "repro_decode_attention": (
            [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
        "repro_decode_merge": ([_P, _P, _P, _I, _I, _I, _I, _P], ctypes.c_int),
        "repro_decode_attention_smem": ([_I, _I, _I], ctypes.c_int),
    },
    "pdist_argmin": {
        "repro_pdist_argmin": ([_P, _P, _P, _P, _LL, _I, _I, _I, _I, _P], ctypes.c_int),
        "repro_pdist_argmin_wide": (
            [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
    },
    "pdist_argmin_tc": {
        "repro_pdist_argmin_tc": (
            [_P, _P, _P, _P, _LL, _I, _I, _I, _P, _P, _P, _P, _P], ctypes.c_int),
        "repro_pdist_argmin_tc_image_bytes": ([_I, _I, _I], ctypes.c_longlong),
    },
    "flash_attention_tf32": {
        "repro_flash_tf32_image_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),
        "repro_flash_tf32_prep": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], ctypes.c_int),
        "repro_flash_attention_tf32": (
            [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
        "repro_flash_attention_tf32_smem": ([_I], ctypes.c_int),
    },
    "flash_attention_tc": {
        "repro_flash_attention_tc": (
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P], ctypes.c_int),
        "repro_flash_attention_tc_smem": ([_I], ctypes.c_int),
    },
    "topk_sparsify": {
        "repro_count_ge": ([_P, _LL, _P, _P, _I, _P], ctypes.c_int),
        "repro_apply_threshold": ([_P, _LL, _P, _P, _I, _P], ctypes.c_int),
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


def _paths(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc on ``csrc/<name>.cu`` unless its library is built:
    ``(src, lib, tmp, process | None, start time)``."""
    src, lib = _paths(name)
    if lib.exists():
        return src, lib, None, None, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    return src, lib, tmp, proc, time.perf_counter()


def _finish(started) -> tuple[Path, float, str]:
    src, lib, tmp, proc, t0 = started
    log = lib.with_suffix(".log")
    if proc is None:
        return lib, 0.0, log.read_text() if log.exists() else ""
    _, stderr = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{stderr[-4000:]}")
    log.write_text(stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds, stderr


def _load(name: str, built) -> None:
    path, seconds, log = built
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    _LIBS[name] = (lib, seconds, log)


def build_all() -> None:
    """Build every source at once (one nvcc each, all started together) and
    load the libraries; what is loaded already is skipped.  A failed build
    raises, and no nvcc is left running."""
    with _LOCK:
        started = [(n, _start(n)) for n in SIGNATURES if n not in _LIBS]
        try:
            for n, st in started:
                _load(n, _finish(st))
        finally:
            for _, (_, _, _, proc, _) in started:
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()


def library(name: str = "wire_kernels"):
    """The loaded ``ctypes`` library for ``csrc/<name>.cu``, built on the
    first call in this process (or reused from ``_build/``)."""
    with _LOCK:
        if name not in _LIBS:
            _load(name, _finish(_start(name)))
        return _LIBS[name][0]


def build_info(name: str = "wire_kernels") -> dict:
    """Seconds the build of ``name`` took in this process (0.0 when a
    library was reused) and nvcc's ``-Xptxas -v`` report."""
    library(name)
    _, seconds, log = _LIBS[name]
    return {"seconds": seconds, "log": log}


def check_rows(x, what: str) -> None:
    """Validate a kernel operand: a contiguous, 16-byte aligned f32 matrix
    on a CUDA device with 1..2^31 - 1 rows of at least one element (the
    kernels loop over rows past grid.y's 65,535 blocks)."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if x.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous (rows, n) matrix")
    if not (1 <= x.shape[0] <= 2**31 - 1 and x.shape[1] >= 1):
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


_SMS: dict = {}


def sm_count(device) -> int:
    """The SM count of CUDA ``device`` (queried once a device)."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def stream_of(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def check(status: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
