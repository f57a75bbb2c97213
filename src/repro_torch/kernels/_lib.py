"""Build the port's CUDA sources at first use and bind them with ctypes.

The sources under ``repro_torch/csrc/`` have a plain C interface (pointers
and the stream as ``void*``, sizes as ``int64_t``; each entry returns
``cudaGetLastError()``).  At the first launch in a process they are
compiled for ``sm_90a`` -- one ``nvcc`` per source, all at once -- and
linked into one shared library under ``build/repro_torch/`` at the root of
the checkout.  The library's name carries a hash of the sources and flags,
so editing a source rebuilds it and ``python3 chip_smoke.py`` alone builds
everything it needs.

Each wrapper counts its launches in :data:`LAUNCHES` (one per launch of
its kernel, nowhere else); :func:`reset_launches` zeroes them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# no --use_fast_math: the parse's weight division must be IEEE `/`
NVCC_FLAGS = ("-std=c++17", "-O3", *ARCH_FLAGS, "-Xcompiler", "-fPIC",
              "-Xptxas=-v")
MIN_CAPABILITY = (9, 0)

LAUNCHES = {"parse_bytes": 0, "parse_accumulate": 0, "exclusive_scan": 0,
            "degree_histogram": 0, "neighbor_gather": 0, "linear_scan": 0,
            "staged_merge": 0}

_LOCK = threading.Lock()
_LIB = None

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
_SIGNATURES = {
    "repro_parse_bytes": ([_P, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                           _P, _P, _P, _P, _P], ctypes.c_int),
    "repro_parse_accumulate_scratch_bytes": ([_I64, _I64, _I64, _I64], _I64),
    "repro_parse_accumulate": ([_P, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                                _P, _P, _P, _I64, _P, _P, _I64, _P, _P],
                               ctypes.c_int),
    "repro_exclusive_scan_scratch_bytes": ([_I64], _I64),
    "repro_exclusive_scan": ([_P, _I64, _P, _P, _P], ctypes.c_int),
    "repro_degree_histogram": ([_P, _I64, _I64, _P, _I64, _P], ctypes.c_int),
    "repro_neighbor_gather": ([_P, _I64, _P, _I64, _I64, _P, _I64, _P, _P,
                               _I64, _P], ctypes.c_int),
    "repro_linear_scan": ([_P, _P, _P, _P, _I64, _I64, _I64, _I64, _P],
                          ctypes.c_int),
    "repro_sort_pairs_scratch_bytes": ([_I64, _I64], _I64),
    "repro_sort_pairs": ([_P, _P, _P, _P, _I64, _I64, _P, _I64,
                          ctypes.POINTER(ctypes.c_int32), _P], ctypes.c_int),
    "repro_staged_merge": ([_P, _P, _I64, _P, _I64, _P, _P, _P, _P, _P],
                           ctypes.c_int),
    "repro_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the port's CUDA kernels are built from source at "
            "first use")
    return found


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libreprotorch_{_digest()}.so"


def build() -> Path:
    """Compile and link the library unless a build of these exact sources
    exists; returns its path.  The compiler's register and shared-memory
    report goes to ``build.log`` beside it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]

    def compile_one(pair):
        src, obj = pair
        return subprocess.run([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)], capture_output=True, text=True)

    with ThreadPoolExecutor(len(objs)) as pool:
        results = list(pool.map(compile_one, zip(sources(), objs)))
    log = "".join(f"== {s.name}\n{r.stdout}{r.stderr}"
                  for s, r in zip(sources(), results))
    failed = [s.name for s, r in zip(sources(), results) if r.returncode]
    if not failed:
        tmp = BUILD_DIR / f"{tag}.so"
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode:
            failed = ["link"]
        else:
            os.replace(tmp, out)
    (BUILD_DIR / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"building the CUDA kernels failed at {failed}:\n"
                           f"{log}")
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes, fn.restype = args, res
            _LIB = handle
    return _LIB


def check_device(t: torch.Tensor) -> None:
    """Refuse a CUDA device the ``sm_90a`` build cannot run on."""
    cap = torch.cuda.get_device_capability(t.device)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(t.device)} has compute capability "
            f"{cap}; the port's kernels are built for sm_90a only "
            f"(capability >= {MIN_CAPABILITY})")


def require(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(status: int, what: str) -> None:
    if status != 0:
        msg = lib().repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
