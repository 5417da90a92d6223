"""Build the port's native sources and load them with ctypes.

Each ``csrc/*.cu`` file exposes an ``extern "C"`` launcher that takes raw
pointers, ints and a stream and returns ``cudaGetLastError()``; ``build``
compiles it with plain ``nvcc``, on the machine with the card. Each
``csrc/*.cc`` file is host-only C++ with a plain C API; ``build_host``
compiles it with ``g++`` (or ``$CXX``), here and on the card's machine
alike, alone or linked with other host sources into one library (the
batch loader ``io_runtime.cc`` with the JPEG decoder ``jpeg.cc``, the
port's one host library). Either is built at first
use into a shared library under ``i2vsgg_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of every source compiled into it, the flags
and the compiler, so that an edit to any of them rebuilds it. Nothing
includes PyTorch's headers and nothing needs ninja, setuptools or Python
headers, so a build takes seconds. A failed build raises with the
compiler's output.
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
# no -ffast-math, no -march=native, no contraction into FMAs: the batch
# loader's f32 resize must round as the JAX package's runtime does on any
# host
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off",
              "-pthread")

_lock = threading.Lock()
_loaded: dict[tuple, ctypes.CDLL] = {}


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


def _sources(source) -> tuple:
    """``source``: one name under ``csrc/`` or a tuple of them."""
    return (source,) if isinstance(source, str) else tuple(source)


def library_path(source, flags=NVCC_FLAGS, compiler: str = "") -> Path:
    """Where ``csrc/<source>`` builds to (the name hashes the source, the
    flags and the compiler). ``source`` may be a tuple of sources linked
    into one library, named after the first: the name then hashes every
    one of them."""
    first, *rest = [CSRC_DIR / s for s in _sources(source)]
    data = first.read_bytes() + b"".join(
        b"\0" + s.name.encode() + b"\0" + s.read_bytes() for s in rest)
    key = hashlib.sha256(data + " ".join(flags).encode() + compiler.encode())
    return BUILD_DIR / f"{first.stem}_{key.hexdigest()[:16]}.so"


def _compile(source, out: Path, cmd_of) -> Path:
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = cmd_of(str(tmp))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}) building "
                           f"{' + '.join(_sources(source))}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
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


def build_host(source) -> Path:
    """Compile ``csrc/<source>`` (host C++; a tuple of sources is linked
    into one library) with ``g++ HOST_FLAGS`` unless its library already
    exists."""
    cxx = find_cxx()
    return _compile(source, library_path(source, HOST_FLAGS, cxx),
                    lambda tmp: [cxx, *HOST_FLAGS, "-o", tmp,
                                 *(str(CSRC_DIR / s)
                                   for s in _sources(source))])


def load(source) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` once per process: a
    ``.cu`` with nvcc, a ``.cc`` (or a tuple of them) with the host
    compiler."""
    key = _sources(source)
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            path = (build_host(source) if key[0].endswith(".cc")
                    else build(source))
            lib = ctypes.CDLL(str(path))
            _loaded[key] = lib
        return lib
