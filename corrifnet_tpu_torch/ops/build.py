"""Build and load the port's CUDA C++ kernels (``corrifnet_tpu_torch/csrc``).

Each ``csrc/*.cu`` file has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into a shared library under ``build/corrifnet_tpu_torch/``
at the root of the checkout, on first use. The library name carries a hash
of the source, the ``csrc/*.cuh`` headers and the flags, so an edited source
rebuilds and a stale library is never loaded. It is bound with ``ctypes``,
not through ``torch.utils.cpp_extension`` (a source that includes PyTorch's
headers takes minutes to compile instead of seconds).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "PLAIN_DEVICES", "load_cuda_library",
           "nvcc_path"]

# The devices on which a kernel wrapper runs its plain version: the CPU, and
# the shape-only meta device (``run.profile`` counts FLOPs there).
PLAIN_DEVICES = ("cpu", "meta")

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "corrifnet_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``/usr/local/cuda`` or ``$PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise FileNotFoundError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "corrifnet_tpu_torch are compiled on the machine with the GPU"
        )
    return found


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:16]}.so"


def _compile(src: Path, lib: Path) -> None:
    """nvcc ``src`` into ``lib``; the ptxas report (registers, shared
    memory, spills) is kept beside it as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}) on {src.name}:\n{res.stdout}\n{res.stderr}"
        )
    lib.with_name(lib.name + ".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, lib)


@functools.lru_cache(maxsize=None)
def load_cuda_library(source_name: str) -> ctypes.CDLL:
    """Compile ``csrc/<source_name>`` if its library is missing, then load it."""
    src = CSRC_DIR / source_name
    lib = _library_path(src)
    if not lib.exists():
        _compile(src, lib)
    return ctypes.CDLL(str(lib))
