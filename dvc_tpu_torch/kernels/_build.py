"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``build/kernels/`` at the repository root (git-ignored), from the
repository's sources only.  The library's file name carries a hash of its
source and flags, so an edited source is never served by a stale build.
No PyTorch headers are compiled: a source builds in seconds, where
``torch.utils.cpp_extension.load`` takes minutes.

Import this module freely: nothing is built or loaded until ``load`` is
called, which is where the first CUDA launch asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless this source's library exists; returns
    its path.  The compiler's report (ptxas registers, shared memory,
    spills) is kept beside it as <library>.log."""
    out = library_path(name)
    if not out.exists():
        compile_library(CSRC / f"{name}.cu", out)
    return out


def compile_library(src: Path, out: Path) -> None:
    """nvcc ``src`` into the shared library ``out`` (written whole or not at
    all), with ptxas's report in ``out``'s .log."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)


def build_all() -> dict[str, float]:
    """Build every source at once, one nvcc each; seconds per source."""
    def timed(name):
        t0 = time.perf_counter()
        build(name)
        return name, time.perf_counter() - t0

    names = sources()
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(pool.map(timed, names))


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
