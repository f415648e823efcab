"""Build the native C++ engines at first use and load them with ctypes.

Each ``<name>.cpp`` here (with the shared header ``dvc_common.h``) is
compiled on its own by ``g++ -O3 -march=native -fPIC -shared -std=c++17
-pthread``, the flags of dvc_tpu/native, into ``build/native/`` at the
repository root (git-ignored).  The library's file name carries a hash of
its source, the header, the flags and the host's CPU (``-march=native``
code may not run on another CPU), so neither an edited source nor a build
directory copied from another machine is served stale.  Preprocessing runs thread pools, so many threads can ask
for the first build at once: the compile is serialized by a lock, goes to a
unique temporary path and lands with an atomic ``os.replace``, so a caller
loads a whole library or waits for one (across processes too).

There is no fallback: a build or load that fails raises, with the
compiler's message.  dvc_tpu turns to other algorithms in that case, which
give other numbers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
HEADER = SRC_DIR / "dvc_common.h"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@functools.lru_cache(maxsize=1)
def _host_cpu() -> bytes:
    """The machine type and the first CPU's model and feature flags."""
    lines = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")) and line not in lines:
                    lines.append(line)
                if not line.strip() and lines:
                    break
    except OSError:
        pass
    return (platform.machine() + "".join(lines)).encode()


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cpp"
    digest = hashlib.sha256(src.read_bytes() + HEADER.read_bytes()
                            + " ".join(CXX_FLAGS).encode() + _host_cpu())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def compile_library(src: Path, out: Path, timeout: int = 600) -> None:
    """g++ ``src`` into the shared library ``out``, written whole or not at
    all; raises RuntimeError with the compiler's stderr on failure."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native engines build with a C++17 compiler")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src.name} (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)


def sources() -> list[str]:
    """Names of the engines' sources here."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cpp"))


def _ensure(name: str) -> Path:
    """The library of ``<name>.cpp``, compiled unless it exists."""
    path = library_path(name)
    if not path.exists():
        compile_library(SRC_DIR / f"{name}.cpp", path)
    return path


def build_all() -> dict[str, float]:
    """Build every engine at once, one g++ each (each lands whole, by its
    own atomic replace); seconds per source."""
    def timed(name):
        t0 = time.perf_counter()
        _ensure(name)
        return name, time.perf_counter() - t0

    names = sources()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(pool.map(timed, names))


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``<name>.cpp``, built at first use; ``declare`` sets
    its functions' argtypes and restypes once, when it is first loaded."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_ensure(name)))
            declare(lib)
            _libs[name] = lib
        return lib
