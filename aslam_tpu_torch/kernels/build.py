"""Build the port's CUDA kernels from `aslam_tpu_torch/csrc/` with nvcc.

Each `csrc/<name>.cu` compiles, on first use in a process, into a shared
library with a plain C interface under `aslam_tpu_torch/_build/`, named by a
hash of its source, and is loaded with ctypes.  A later process finds the
library of an unchanged source and loads it without compiling.  The build
uses only the repository's sources and the CUDA toolkit:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

`python -m aslam_tpu_torch.kernels.build` builds every kernel and prints
what `-Xptxas -v` reports for each (registers, shared memory, spills).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message holds its output."""


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, /usr/local/cuda "
            "and PATH); the CUDA kernels build only where the CUDA toolkit is")
    return found


def _source_hash(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(name: str, verbose: bool = False) -> Path:
    """Compile `csrc/<name>.cu` unless its library is built; -> library path."""
    src = CSRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"{name}-{_source_hash(src)}.so"
    if out.is_file() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}) on {src.name}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, end="", flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library `name`, once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


if __name__ == "__main__":
    for kernel in kernel_names():
        print(f"{kernel}: {build(kernel, verbose=True)}", flush=True)
