"""Build the native PNG decoder / prefetcher: `python -m
aslam_tpu_torch.native.build`.

Host C++ (`png_loader.cpp`, `prefetcher.cpp`; zlib and pthreads), compiled
with g++ into `aslam_tpu_torch/_build/`, never beside the sources, under a
name that carries a hash of the sources: an unchanged source is not compiled
again.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
SOURCES = ("png_loader.cpp", "prefetcher.cpp")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the sources; the message says which."""


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libaslam_native-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """-> the library's path, compiling it first if it is not there."""
    out = lib_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile beside the target, then rename: a concurrent process never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [gxx, *FLAGS, *(str(SRC_DIR / s) for s in SOURCES), "-o", tmp, "-lz"]
    if verbose:
        print("+", " ".join(cmd), flush=True)
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise NativeBuildError(f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, out)
    return out


if __name__ == "__main__":
    print("built", build(verbose=True))
