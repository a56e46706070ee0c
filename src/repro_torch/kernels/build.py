"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``.cu`` file with a plain C interface, compiled for
Hopper (``sm_90a``) into a shared library under ``build/repro_torch_kernels/``
at the repository root (git-ignored), at first use.  The library's file
name carries a hash of the source and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  ``build_all`` starts one
``nvcc`` per source, all together, and loads each library when its own
compiler has finished.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


class CudaLibrary:
    """One ``.cu`` source -> one ``ctypes.CDLL``, built on first ``load``.

    ``symbols`` maps each exported C function to its ``argtypes``; every
    function returns a ``cudaError_t`` as ``int``.
    """

    def __init__(self, source: Path, symbols: dict[str, list]):
        self.source = Path(source)
        self.symbols = symbols
        self._lib: ctypes.CDLL | None = None
        self.ptxas_log = ""

    @property
    def path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{h}.so"

    def _start_build(self) -> tuple[subprocess.Popen, Path]:
        """Start ``nvcc`` into a temporary file; ``_finish_build`` moves it into place."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        return proc, tmp

    def _finish_build(self, proc: subprocess.Popen, tmp: Path) -> None:
        self.ptxas_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{self.ptxas_log}")
        os.replace(tmp, self.path)

    def load(self) -> ctypes.CDLL:
        """Build the library unless it exists, then load and bind it."""
        if self._lib is None:
            if not self.path.exists():
                self._finish_build(*self._start_build())
            lib = ctypes.CDLL(str(self.path))
            for name, argtypes in self.symbols.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib


def build_all(libraries) -> None:
    """Build every library not built yet, one ``nvcc`` per source, all
    started together; then load each.  Raises after every compiler has
    finished if any of them failed."""
    started = [(lib, *lib._start_build()) for lib in libraries
               if lib._lib is None and not lib.path.exists()]
    errors = []
    for lib, proc, tmp in started:
        try:
            lib._finish_build(proc, tmp)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for lib in libraries:
        lib.load()
