"""Build the native sources of `csrc/` into shared libraries, loaded with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
-Xptxas -v` (ptxas's report of each kernel's registers, shared memory and
spills is kept in `BUILD_LOG`);
each `csrc/<name>.cpp` (host code: the rANS coder) by
`g++ -O3 -std=c++17 -shared -fPIC`.  Both build at first use into
`lssvc_tpu_torch/_build/` (listed in .gitignore).  The library's file name
carries a hash of its source and flags, so an edited source rebuilds; a
lock file keeps concurrent processes (pytest workers) from building the
same library at once.  `build_all` runs one compiler per source, all at
once.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when a built
# library was found on disk)
BUILD_SECONDS: dict[str, float] = {}
# the compiler's output of each library built in this process (nvcc: ptxas's
# -v report)
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source(name: str) -> tuple[Path, tuple]:
    """(source, flags): `csrc/<name>.cu` for nvcc, else `csrc/<name>.cpp`
    for g++."""
    cu = CSRC_DIR / f"{name}.cu"
    if cu.exists():
        return cu, NVCC_FLAGS
    return CSRC_DIR / f"{name}.cpp", GXX_FLAGS


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` or `.cpp` unless a library of the same
    source exists."""
    lib = library_path(name)
    if lib.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not lib.exists():
                t0 = time.perf_counter()
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                src, flags = _source(name)
                compiler = nvcc_path() if src.suffix == ".cu" else "g++"
                cmd = [compiler, *flags, "-o", str(tmp), str(src)]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{Path(cmd[0]).name} failed ({proc.returncode}) on "
                        f"{src.name}:\n{proc.stdout}\n{proc.stderr}")
                os.replace(tmp, lib)
                BUILD_SECONDS[name] = time.perf_counter() - t0
                BUILD_LOG[name] = proc.stdout + proc.stderr
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    BUILD_SECONDS.setdefault(name, 0.0)
    return lib


def build_all(names) -> list[Path]:
    """Compile several sources concurrently, one compiler process each."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futures = [pool.submit(build, name) for name in names]
        return [f.result() for f in futures]


def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu` or `.cpp`, built on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
