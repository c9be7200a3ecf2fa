"""Build and load the port's CUDA kernels.

Each kernel is one ``.cu`` file with a plain ``extern "C"`` interface,
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library and
loaded with ``ctypes`` (no PyTorch headers, no ninja).  The sources of a
directory share its ``.cuh`` headers.  Libraries are built at first use
into ``build/kernels/`` at the repository root, named by a hash of the
source, the headers beside it and the flags, so an edited source or
header rebuilds and an unchanged one is reused.  A missing ``nvcc`` or a
failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}   # library path -> nvcc/ptxas output


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(cuda_home, "bin", "nvcc")
        if os.path.exists(candidate):
            nvcc = candidate
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built")
    return nvcc


def library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its hashed library already exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                              str(source)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source.name} (exit {res.returncode}):\n"
                f"{res.stderr}{res.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOGS[str(out)] = res.stderr + res.stdout
    return out


def build_all(sources) -> list[Path]:
    """Build several sources at once, one ``nvcc`` process each."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(build, sources))


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and ``dlopen`` the library of one ``.cu`` file;
    refused under a fake trace, which never reaches a kernel's library."""
    from repro_torch import _device
    if _device.tracing():
        raise RuntimeError(f"a fake trace reached the library of {source}: "
                           "a kernel on a dry run's path is a custom op "
                           "with a fake, never a ctypes launch")
    path = str(build(source))
    lib = _LOADED.get(path)
    if lib is None:
        lib = _LOADED[path] = ctypes.CDLL(path)
    return lib
