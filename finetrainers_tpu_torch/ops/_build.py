"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
into a shared library under `_build/` (listed in `.gitignore`) at first use,
then loaded with `ctypes`. The library name carries a hash of every file in
`csrc/` (a source may include another: the branch libraries include their
kernels' source) and of the flags, so an edited file is rebuilt and a stale
library is never loaded. `load_libraries` starts one nvcc per source at once;
`SOURCES` names every library.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Every library: K1 and K7a/b/c; K1's mask, causal and segment branches; K7c's
# branches and K7a's and K7b's segment branches; K2, K3 and K5; K2's and K3's
# branches; K5's branches; the pre-pass and K5's dq emit; the sage pre-pass and K6.
SOURCES = ("flash_fwd_sm90", "flash_fwd_branches_sm90", "flash_fwd_variant_branches_sm90", "flash_bwd_sm90",
           "flash_bwd_branches_sm90", "flash_bwd_fused_branches_sm90", "flash_bwd", "sage_fwd_sm90")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# name -> {"seconds": build time (0.0 when the library was already built), "log": nvcc stderr}
BUILD_LOG: Dict[str, dict] = {}


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")


def _lib_path(name: str) -> pathlib.Path:
    """The library's path, named by a hash of its name, every file of csrc/ (a
    shared header or an included source may change it) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + name.encode())
    for path in sorted(p for p in CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh", ".h")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load_libraries(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Build each `csrc/<name>.cu` that is not built yet, one nvcc process per
    source, all started together, and return the loaded libraries by name."""
    with _LOCK:
        names = list(names)
        builds = {}
        for name in names:
            if name in _LIBS:
                continue
            lib_path = _lib_path(name)
            if lib_path.exists():
                BUILD_LOG[name] = {"seconds": 0.0, "log": ""}
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            cmd = [_find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            builds[name] = (proc, tmp, lib_path, time.perf_counter())
        failed = []
        for name, (proc, tmp, lib_path, t0) in builds.items():
            _, stderr = proc.communicate()  # waits for every build, failed or not
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build csrc/{name}.cu (exit {proc.returncode}):\n{stderr}")
                continue
            os.replace(tmp, lib_path)
            BUILD_LOG[name] = {"seconds": seconds, "log": stderr}
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _LIBS:
                _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return {name: _LIBS[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if needed and return the loaded library."""
    return load_libraries([name])[name]
