"""Build and load the hand-written CUDA kernels under `csrc/`.

Each source is compiled by `nvcc` into its own shared library with a
plain C interface and loaded with `ctypes` (no PyTorch headers: a build
takes seconds, not minutes).  Libraries land in `build/torch_kernels/`
at the repository root, named by a hash of their source, and are built
at first use.  `build_all` starts every missing build at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class Kernel:
    """One CUDA source, its library, and the launch count of its wrapper."""

    def __init__(self, name: str, source: str, replaces: str,
                 signatures: dict):
        self.name = name
        self.source = CSRC / source
        self.replaces = replaces
        self.signatures = signatures  # C function -> ctypes argtypes
        self.launches = 0
        self._lib = None
        self.build_log = ""

    @property
    def lib_path(self) -> Path:
        digest = hashlib.sha1(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}-{digest}.so"

    def _build_cmd(self, tmp: Path) -> list:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]

    def lib(self):
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.lib_path))
            for fn, argtypes in self.signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        err = getattr(self.lib(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: {fn} failed with cudaError {err}")


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build_all(kernels) -> None:
    """Compile every kernel whose library is missing, all in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in kernels:
        if k.lib_path.exists():
            continue
        tmp = k.lib_path.with_suffix(f".{os.getpid()}.tmp")
        procs.append((k, tmp, subprocess.Popen(
            k._build_cmd(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for k, tmp, p in procs:
        k.build_log = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"{k.source.name}:\n{k.build_log}")
        else:
            os.replace(tmp, k.lib_path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def ptr(t) -> ctypes.c_void_p:
    """Device pointer of a tensor (None -> a null pointer)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def current_stream(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_cuda(t, name: str, dtype, ndim: int | None = None) -> None:
    """Wrapper-side checks before a launch."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
