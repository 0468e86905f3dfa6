"""ctypes bindings for the native host library (`native/src/*.cpp`).

Counterpart of `sam6d_tpu/utils/native.py`, over the same C++ sources
(the z-buffer rasterizer and the RLE codec, host-side hot loops) with
its flags, `g++ -O3 -std=c++17 -shared -fPIC`, but built by the port
into `build/native/libsam6d_native.so` of the repository (never into
`native/build/`).  The port binds the rasterizer only; its RLE stays
numpy (`utils/rle.py`).  The library is built at its first use, never at
import, and again when a source is newer than it.  A failed build warns
once and keeps the compiler's output (`build_error()`); the callers then
take the numpy rasterizer, which gives the same renders up to boundary
pixels (`tests/test_torch_native.py`).

$SAM6D_NO_NATIVE set (read at every call) sends every caller to numpy;
$SAM6D_NATIVE_LIB names a prebuilt library to load instead of building.
"""

from __future__ import annotations

import collections
import ctypes
import os
import subprocess
import threading
import time
import warnings
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
SRC_DIR = REPO_ROOT / "native" / "src"
BUILD_DIR = REPO_ROOT / "build" / "native"
LIB_NAME = "libsam6d_native.so"
NO_NATIVE_ENV = "SAM6D_NO_NATIVE"
LIB_ENV = "SAM6D_NATIVE_LIB"


class NativeLibrary:
    """The library built into `build_dir` and loaded once.  `calls` counts
    the native calls made (`rasterize`); `build_s` is the compile's wall
    time, None if nothing was built."""

    def __init__(self, build_dir: str | os.PathLike = BUILD_DIR):
        self.path = Path(build_dir) / LIB_NAME
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._tried = False
        self.build_error: str | None = None
        self.build_s: float | None = None
        self.calls: collections.Counter = collections.Counter()

    def _stale(self, sources) -> bool:
        if not self.path.exists():
            return True
        built = self.path.stat().st_mtime
        return any(s.stat().st_mtime > built for s in sources)

    def _build(self) -> bool:
        sources = sorted(SRC_DIR.glob("*.cpp"))
        if not self._stale(sources):
            return True
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # A private output renamed into place: concurrent builders (test
        # workers) never load a half-written file.
        tmp = self.path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
               *map(str, sources), "-o", str(tmp)]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.SubprocessError) as e:
            self.build_error = f"{' '.join(cmd)}: {e}"
            return False
        if proc.returncode != 0:
            self.build_error = (f"{' '.join(cmd)} exited {proc.returncode}:\n"
                                f"{proc.stderr}")
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, self.path)
        self.build_s = time.perf_counter() - t0
        return True

    def load(self) -> ctypes.CDLL | None:
        """The loaded library, building it if needed; None when
        $SAM6D_NO_NATIVE is set or the build or load failed."""
        if os.environ.get(NO_NATIVE_ENV):
            return None
        if self._tried:
            return self._lib
        with self._lock:
            if self._tried:
                return self._lib
            self._tried = True
            path = os.environ.get(LIB_ENV)
            if not path:
                if not self._build():
                    warnings.warn("native library build failed; using the "
                                  "numpy versions (native.build_error() has "
                                  "the compiler's output)", RuntimeWarning)
                    return None
                path = str(self.path)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                self.build_error = f"loading {path}: {e}"
                warnings.warn(f"native library not loaded: {e}",
                              RuntimeWarning)
                return None
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            c_int = ctypes.c_int
            lib.sam6d_rasterize.argtypes = [
                f32p, c_int, i32p, c_int, f32p, c_int, c_int, f32p, c_int,
                f32p, f32p, u8p,
            ]
            lib.sam6d_rasterize.restype = None
            self._lib = lib
            return lib

    def rasterize(self, verts_cam, faces, K, hw, vert_attrs):
        """Z-buffer rasterization with the contract of
        `pipeline/renderer.rasterize_numpy`: (attr_img (H, W, A), mask
        (H, W) bool, depth (H, W), inf where uncovered); None without the
        library."""
        lib = self.load()
        if lib is None:
            return None
        H, W = hw
        verts = np.ascontiguousarray(verts_cam, np.float32)
        f = np.ascontiguousarray(faces, np.int32)
        k = np.ascontiguousarray(K, np.float32)
        attrs = np.ascontiguousarray(vert_attrs, np.float32)
        if verts.ndim != 2 or verts.shape[1] != 3 or f.ndim != 2 \
                or f.shape[1] != 3 or k.shape != (3, 3) \
                or attrs.shape[0] != len(verts):
            raise ValueError(
                f"rasterize: verts {verts.shape}, faces {f.shape}, K "
                f"{k.shape}, attrs {attrs.shape}")
        A = attrs.shape[1]
        attr_img = np.empty((H, W, A), np.float32)
        depth = np.empty((H, W), np.float32)
        mask = np.empty((H, W), np.uint8)
        lib.sam6d_rasterize(verts, len(verts), f, len(f), k, H, W, attrs, A,
                            attr_img, depth, mask)
        self.calls["rasterize"] += 1
        return attr_img, mask.astype(bool), depth


LIBRARY = NativeLibrary()


def build_error() -> str | None:
    """The compiler's (or loader's) message of a failed attempt, else
    None."""
    return LIBRARY.build_error


def rasterize(verts_cam, faces, K, hw, vert_attrs):
    return LIBRARY.rasterize(verts_cam, faces, K, hw, vert_attrs)

