"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled for ``sm_90a`` into ``_build/<name>-<hash>.so``, where the hash
covers the source and the flags, so a library is rebuilt only when its
source changes. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
SOURCES = ("fused_sample", "lrelu_pnorm")

_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(nvcc)


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


class _Build:
    """One nvcc process writing ``csrc/<name>.cu``'s library to a temporary
    file that replaces the final path only when the build succeeds."""

    def __init__(self, name: str):
        self.name = name
        self.out = library_path(name)
        self.proc = None
        if self.out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.tmp = self.out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(self.tmp),
               str(CSRC / f"{name}.cu")]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def wait(self) -> Path:
        if self.proc is not None:
            log, _ = self.proc.communicate()
            if self.proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.name}.cu:\n{log}")
            os.replace(self.tmp, self.out)
        return self.out


def build_all(names=SOURCES) -> None:
    """Build every missing library, one nvcc per source, all started together.
    If one build fails, the others are stopped before the error is raised."""
    builds = [_Build(name) for name in names]
    try:
        for build in builds:
            build.wait()
    finally:
        for build in builds:
            if build.proc is not None and build.proc.poll() is None:
                build.proc.kill()
                build.proc.wait()


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built on first use."""
    lib = _libraries.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_Build(name).wait()))
        lib.lf_error_string.argtypes = [ctypes.c_int]
        lib.lf_error_string.restype = ctypes.c_char_p
        _libraries[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        message = lib.lf_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({message})")
