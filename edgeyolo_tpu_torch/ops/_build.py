"""Build the port's native sources and load them with ctypes.

Two routes, one naming scheme:
- CUDA: each `csrc/<name>.cu` exposes a plain C interface and includes no
  PyTorch header, so one `nvcc ... -shared` per source takes seconds.
- Host C++: each `csrc/<name>.cpp` (the image codec, the polygon fill) is
  compiled by `g++`.
  It needs no card, so it builds on a CPU-only machine too and the CPU tests
  run the real code.

Libraries go to `edgeyolo_tpu_torch/_build/<name>-<hash>.so`, where the hash
covers the source and the flags: a changed source builds anew, an unchanged
one is loaded as it is. A build writes a temporary file and renames it into
place, so concurrent builds (test workers) never load a half-written
library. A failed build raises. Nothing is built when a module is imported;
the first call (or `build()`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("linear_attention", "int8_conv")  # CUDA
HOST_SOURCES = ("imageio", "rasterize")  # host C++
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC", "-pthread")

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # wall time of each source's last build in this process


def find_nvcc() -> str:
    """nvcc from PATH, else under CUDA_HOME, else under the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH or set CUDA_HOME")


def find_cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("no host C++ compiler: put g++ on PATH")
    return found


def _source(name: str) -> tuple[Path, tuple[str, ...]]:
    if name in HOST_SOURCES:
        return CSRC / f"{name}.cpp", HOST_FLAGS
    return CSRC / f"{name}.cu", NVCC_FLAGS


def library_path(name: str) -> Path:
    src, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes() + "\0".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES + HOST_SOURCES) -> dict[str, Path]:
    """Compile every source whose library is missing, all compilers at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        src, flags = _source(name)
        compiler = find_cxx() if name in HOST_SOURCES else find_nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *flags, "-o", str(tmp), str(src)]
        jobs.append((name, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))

    def finish(job):  # each compiler waited on in its own thread: its own wall time
        log, _ = job[4].communicate()
        return log, time.perf_counter() - job[3]

    with ThreadPoolExecutor(max(len(jobs), 1)) as pool:
        ends = list(pool.map(finish, jobs))
    failed = []
    for (name, out, tmp, _, proc), (log, seconds) in zip(jobs, ends):
        build_seconds[name] = seconds
        if proc.returncode != 0:
            failed.append(f"{_source(name)[0].name} ({Path(proc.args[0]).name} exit "
                          f"{proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent reader sees no half-written library
    if failed:
        raise RuntimeError("native build failed\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu or .cpp, built first if needed."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build((name,))[name]))
    return _libs[name]
