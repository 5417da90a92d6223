"""Build the port's native sources and load them with ctypes.

Each ``csrc/*.cu`` file exposes an ``extern "C"`` launcher that takes raw
pointers, ints and a stream and returns ``cudaGetLastError()``; ``build``
compiles it with plain ``nvcc``, on the machine with the card. Each
``csrc/*.cc`` file is host-only C++ with a plain C API (the JPEG decoder);
``build_host`` compiles it with ``g++`` (or ``$CXX``), here and on the
card's machine alike. Either is built at first use into a shared library
under ``i2vsgg_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the source, the flags and the compiler, so that an edited source is
rebuilt. Nothing includes PyTorch's headers and nothing needs ninja,
setuptools or Python headers, so a build takes seconds. A failed build
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on ``PATH``."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: set CXX or put g++ on PATH")
    return cxx


def library_path(source: str, flags=NVCC_FLAGS, compiler: str = "") -> Path:
    """Where ``csrc/<source>`` builds to (the name hashes the source, the
    flags and the compiler)."""
    src = CSRC_DIR / source
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                         + compiler.encode())
    return BUILD_DIR / f"{src.stem}_{key.hexdigest()[:16]}.so"


def _compile(source: str, out: Path, cmd_of) -> Path:
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = cmd_of(str(tmp))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}) building "
                           f"{source}:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)       # atomic: a concurrent build loses nothing
    return out


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` (CUDA) unless its library already exists.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills
    per kernel) is kept beside the library as ``<name>.log``.
    """
    return _compile(source, library_path(source), lambda tmp: [
        find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)])


def build_host(source: str) -> Path:
    """Compile ``csrc/<source>`` (host C++) with ``g++ -O2 -shared -fPIC
    -std=c++17`` unless its library already exists."""
    cxx = find_cxx()
    return _compile(source, library_path(source, HOST_FLAGS, cxx),
                    lambda tmp: [cxx, *HOST_FLAGS, "-o", tmp,
                                 str(CSRC_DIR / source)])


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` once per process: a
    ``.cu`` with nvcc, a ``.cc`` with the host compiler."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path = (build_host(source) if source.endswith(".cc")
                    else build(source))
            lib = ctypes.CDLL(str(path))
            _loaded[source] = lib
        return lib
