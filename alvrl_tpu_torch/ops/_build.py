"""Build of the hand-written CUDA kernels and of the host libraries.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for sm_90a, one process per
source, all started together, and the objects are linked into one
shared library with a plain C interface, which the wrappers load with
ctypes. The library goes to ``alvrl_tpu_torch/_build/`` (ignored by
git) under a name that carries the hash of the sources (headers
included) and flags, so a change to either rebuilds it at first use. A
failed build raises.

The C++ sources of ``native/`` that the port calls (the cluster refiner,
the BVH builder) are compiled by g++ as they are, with native/Makefile's
flags, into the same directory, under a name that carries the hash of
the source, the flags and the host CPU (-march=native builds for this
CPU), so a library built on another machine is never loaded
(``gxx_library_path``, ``build_gxx``). Nothing runs make in native/,
whose tracked .so stays as it is.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return nvcc


def _library_path() -> Path:
    sources = sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libalvrl_kernels-{digest.hexdigest()[:16]}.so"


def _run(procs):
    """Wait for all (cmd, Popen) pairs, then raise if one failed."""
    logs = ["".join(proc.communicate()) for _, proc in procs]
    done = [(cmd, proc.returncode, log)
            for (cmd, proc), log in zip(procs, logs)]
    for cmd, code, log in done:
        if code != 0:
            raise RuntimeError(
                f"nvcc failed with code {code}:\n{' '.join(cmd)}\n{log}")
    return "".join(log for _, _, log in done)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    lib_path = _library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs, procs = [], []
            for src in sorted(CSRC_DIR.glob("*.cu")):
                obj = os.path.join(tmp, f"{src.stem}.o")
                cmd = [nvcc, *COMPILE_FLAGS, "-o", obj, str(src)]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True)))
                objs.append(obj)
            log = _run(procs)
            tmp_lib = os.path.join(tmp, lib_path.name)
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib, *objs]
            log += _run([(cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))])
            lib_path.with_suffix(".log").write_text(log)
            os.replace(tmp_lib, lib_path)
    return ctypes.CDLL(str(lib_path))


def build_log() -> str:
    """The compiler's report (ptxas registers, shared memory, spills) of
    the library that load_library built, or "" if it has not built one."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def host_cpu() -> bytes:
    """The CPU's model and flags (-march=native builds for this CPU)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    return b"\n".join(next((ln for ln in lines if ln.startswith(key)), b"")
                      for key in (b"model name", b"flags"))


def gxx_library_path(source: Path, flags, stem: str) -> Path:
    """The g++ library of `source` in BUILD_DIR: stem-<hash of the
    flags, the source and the host CPU>.so."""
    digest = hashlib.sha256(" ".join(flags).encode())
    digest.update(source.read_bytes())
    digest.update(host_cpu())
    return BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"


def build_gxx(source: Path, flags, lib_path: Path) -> None:
    """Compile `source` with g++ ($CXX if set) and `flags` into lib_path,
    unless it exists; raise if the source is missing or g++ fails."""
    if lib_path.exists():
        return
    if not source.is_file():
        raise RuntimeError(f"{source} not found; its library cannot be built")
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found (set CXX); {source.name} cannot "
                           "be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = os.path.join(tmp, lib_path.name)
        cmd = [cxx, *flags, "-o", tmp_lib, str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed with code {proc.returncode}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp_lib, lib_path)
