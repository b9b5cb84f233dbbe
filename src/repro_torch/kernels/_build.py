"""Build and bind the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds.  Libraries go to ``kernels/_build/`` inside the
package, named by a hash of the sources and flags, so a changed source is
rebuilt and an unchanged one is reused.  Nothing is built when a module is
imported: ``load`` builds on first use, and ``build_all`` starts one
``nvcc`` per source at once.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on a non-zero code.  The launch
counters (``LAUNCHES``) are bumped by the wrappers, once per kernel launch
and nowhere else, so a run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = [
    "LAUNCHES",
    "build_all",
    "check",
    "count_launch",
    "lane_ptr",
    "load",
    "nvcc_path",
    "reset_launches",
    "stream_of",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = (
    "ddsketch_ingest",
    "fold_pairs",
    "bank_quantiles",
    "bank_range_merge",
    "ddsketch_seg_hist",
    "ddsketch_hist",
    "ddsketch_scatter",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float


def count_launch(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels of repro_torch are built from source at first use"
        )
    return found


def _library_path(name: str, nvcc: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join((nvcc, *NVCC_FLAGS)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    """Start ``nvcc`` for a missing library: ``(lib, tmp, proc)``, with
    ``proc`` None when the library is already built."""
    lib = _library_path(name, nvcc)
    if lib.exists():
        return lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return lib, tmp, proc


def _finish(name: str, lib: Path, tmp: Path | None, proc) -> Path:
    if proc is None:
        return lib
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)
    return lib


def build_all(names=KERNELS) -> dict[str, Path]:
    """Build every named kernel library that is missing, one ``nvcc`` per
    source, all started together; returns the library paths."""
    nvcc = nvcc_path()
    started = {name: _start(name, nvcc) for name in names}
    return {name: _finish(name, *started[name]) for name in names}


def load(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use, with ``argtypes``
    set from ``signatures`` (C function name -> argument types); every
    entry point returns an ``int`` CUDA error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        nvcc = nvcc_path()
        path = _finish(name, *_start(name, nvcc))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def lane_ptr(t, dtype, what: str, n: int, device) -> int:
    """Pointer of a contiguous ``(n,)`` lane tensor of ``dtype`` on
    ``device``; raises on anything else."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, values on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != 1 or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous ({n},) tensor, got {tuple(t.shape)}")
    return t.data_ptr()
