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
        _c_int, _c_ptr, _c_ptr, _c_ptr, _c_int,            # M pos valid bstarts nb
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr],           # scr pg oc og stream
    "ba_prepare_reduction": [
        _c_ptr, _c_ll, _c_int, _c_int, _c_int, _c_int, _c_int,  # pk N P V pb G M
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int,            # hpp pos valid bstarts nb
        _c_ptr, _c_int, _c_ptr, _c_ptr,                    # feat fs prg pt
        _c_ptr, _c_ptr, _c_ptr, _c_ptr],                   # red rg t23 stream
    "ba_prepare_fits": [_c_int, _c_int, _c_int, _c_int],   # pb V G max_smem
    "ba_read_floor": [
        _c_ptr, _c_ll, _c_int, _c_int, _c_int, _c_int,     # packed N P V pb rows
        _c_ptr, _c_ptr, _c_ptr, _c_ptr],                   # xin part out stream
    "ba_matvec_stage": [
        _c_int, _c_ptr, _c_ll, _c_int, _c_int, _c_int, _c_int,  # st pk N P V pb G
        _c_ptr, _c_ptr, _c_ptr, _c_ptr,                    # img hpp xc xg
        _c_ptr, _c_ptr, _c_ptr],                           # part out stream
    "ba_image_sum": [
        _c_int, _c_ptr, _c_ptr, _c_int, _c_int, _c_ll,     # s rows lead F L N
        _c_int, _c_ptr, _c_ptr, _c_ptr, _c_int,            # M pos valid bstarts nb
        _c_ptr, _c_ptr, _c_int, _c_ptr],                   # scr out ldo stream
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
    library is already there): one nvcc per source, all started together,
    then one link.  ``verbose`` adds ptxas resource usage to the log."""
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
    work = Path(tempfile.mkdtemp(dir=out_dir))
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    if verbose:
        flags.append("-Xptxas=-v")
    t0 = time.time()
    try:
        procs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj = work / (src.stem + ".o")
            procs.append((obj, subprocess.Popen(
                [nvcc, *flags, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{obj.stem}.cu (exit {proc.returncode})")
        log = "".join(logs)
        if failed:
            raise KernelBuildError(f"nvcc failed: {', '.join(failed)}:\n"
                                   f"{log[-4000:]}")
        tmp = work / LIB_NAME
        res = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *(str(obj) for obj, _ in procs)],
            capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise KernelBuildError(
                f"nvcc link failed (exit {res.returncode}):\n{log[-4000:]}")
        # atomic: concurrent builders never see a partial .so
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return BuildResult(lib, time.time() - t0, log)


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
