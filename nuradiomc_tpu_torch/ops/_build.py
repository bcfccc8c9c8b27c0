"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled at first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` (and the kernel's ``EXTRA_FLAGS``) into ``build/kernels/`` at the
repository root (gitignored), named by a hash of its source, its flags and
the shared ``csrc/*.cuh`` headers so an edited kernel is rebuilt, and loaded
with
``ctypes``. :func:`build` compiles several sources at once, one nvcc process
each. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# flags of single kernels, after NVCC_FLAGS: the ray solver's, the chord
# integral's and the birefringence scan's products and sums round one by
# one, as the plain versions' ATen ops and the numpy copy's do
EXTRA_FLAGS = {"ray_solver": ["-fmad=false"], "earth_slant": ["-fmad=false"],
               "birefringence_scan": ["-fmad=false"]}

_libs: dict[str, ctypes.CDLL] = {}
# per kernel: {"seconds": build time (0.0 when cached), "log": ptxas output}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built "
                       "where the CUDA toolkit is installed")


def _flags(name: str):
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(_flags(name)).encode()
                            ).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}_{digest}.so"


def build(names) -> None:
    """Compile the named kernels that are not built yet, one nvcc process
    per source, all started together."""
    running = []
    for name in names:
        src, so = _paths(name)
        if name in _libs or so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *_flags(name), "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, src, so, tmp, proc, time.perf_counter()))
    for name, src, so, tmp, proc, t0 in running:
        log = proc.communicate()[0]
        build_info[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{log}")
        os.replace(tmp, so)


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    if name not in _libs:
        build([name])
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        _libs[name] = ctypes.CDLL(str(_paths(name)[1]))
    return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def current_stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
