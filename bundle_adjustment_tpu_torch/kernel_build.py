"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with nvcc for Hopper (``sm_90a``) into one shared
library with a plain C interface, loaded with ctypes.  The build happens at
first use into ``.kernels_build/<hash of the sources>/`` at the repository
root, so a fresh checkout builds itself and a changed source rebuilds.

There is no stand-in: without nvcc, or when the build fails, `library()`
raises `KernelBuildError`.  Callers that hold CUDA tensors must launch the
kernels or fail.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / ".kernels_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
LIB_NAME = "libba_kernels.so"

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong

# C signatures of csrc/*.cu (every pointer and the stream as c_void_p)
SIGNATURES = {
    "ba_cam_gather": [_c_ptr, _c_int, _c_int, _c_ptr, _c_ll, _c_ptr, _c_ptr],
    "ba_schur_matvec": [
        _c_ptr, _c_ll, _c_int, _c_int, _c_int, _c_int,     # packed N P V pb G
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,    # img hpp xc xg ec eg
        _c_int, _c_ptr, _c_ptr,                            # M perm bstarts
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr],           # scr pg oc og stream
    "ba_prepare_reduction": [
        _c_ptr, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int,  # pk N P V pb G M
        _c_ptr, _c_ptr, _c_ptr,                            # hpp perm bstarts
        _c_ptr, _c_int, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int,  # scratch
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr],           # red rg t2 t3 stream
}


class KernelBuildError(RuntimeError):
    """nvcc is missing, the build failed, or the library did not load."""


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0 when the library was already built
    log: str        # nvcc's output ("" when already built)


_LIB = None


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    return None


def sources() -> list[Path]:
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def source_hash() -> str:
    h = hashlib.sha256()
    for s in sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> BuildResult:
    """Compile csrc/*.cu into the hash-keyed build directory (no-op when the
    library is already there).  ``verbose`` adds ptxas resource usage to
    the log."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return BuildResult(lib, 0.0, "")
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found ($CUDA_HOME/bin, $PATH, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built here")
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sources() if s.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-o", tmp, *cu]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.time() - t0
    log = res.stdout + res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise KernelBuildError(
            f"nvcc failed (exit {res.returncode}):\n{log[-4000:]}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial .so
    return BuildResult(lib, seconds, log)


def library():
    """The loaded kernel library (built on first use); raises
    `KernelBuildError` when it cannot be built or loaded."""
    global _LIB
    if _LIB is None:
        path = build().path
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            raise KernelBuildError(f"cannot load {path}: {exc}") from exc
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
