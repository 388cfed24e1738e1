"""Build and load the port's CUDA kernels and its host library.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, then loaded with ``ctypes``. The
library lands in ``adamvs_tpu_torch/_build/`` under a name that carries the
hash of the source and the flags, so an edited source is rebuilt at its next
use. A failed build raises; there is no fallback.

The host library (``csrc/host/*.cc``: PNG and EXR decoding, image centring
and resizing for the loaders, loaded by ``io/native.py``) is compiled the
same way by ``g++`` with OpenMP and linked to zlib (``build_host``). Its
name also carries the target that ``-march=native`` resolves to, so a library
built on one machine is never loaded on another.

Nothing here runs at import time: a kernel is built the first time its wrapper
launches it (``load_library``), or all at once by ``build_all()``;
``load_library`` builds through ``build_all``. The host library is built the
first time a reader calls it (``io/native.py``), or by ``build_host()``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


HOST_SRC = os.path.join(CSRC, "host")
CXX = "g++"
HOST_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-fopenmp"]
HOST_LIBS = ["-lz"]
_HOST_BUILD = threading.Lock()  # one host build at a time in a process (the loaders' threads)


def sources() -> list[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for f in sorted(os.listdir(CSRC)):
        if f == f"{name}.cu" or f.endswith(".cuh"):
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for ``name`` unless its library is built. Returns
    (process, temp output, final path, log file) or None."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    log = tempfile.TemporaryFile(mode="w+")
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log


def _finish(job) -> tuple[int, str]:
    """Wait for a build started by ``_start`` and install its library if it
    built. Returns (exit code, compiler output)."""
    proc, tmp, out, log = job
    try:
        rc = proc.wait()
        log.seek(0)
        text = log.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    if rc == 0:
        os.replace(tmp, out)
    else:
        os.unlink(tmp)
    return rc, text


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Build the named kernel sources (all by default): one nvcc process per
    source, all started together and all waited for. Returns {name: ptxas
    report} for the sources built in this call (built ones are skipped);
    raises with the compiler's output if any source failed."""
    jobs = {n: job for n in (names or sources()) if (job := _start(n)) is not None}
    done = {n: _finish(job) for n, job in jobs.items()}
    for n, (rc, text) in done.items():
        if rc != 0:
            raise RuntimeError(f"nvcc failed for csrc/{n}.cu (exit {rc}):\n{text}")
    return {n: text for n, (_, text) in done.items()}


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    build_all([name])
    return ctypes.CDLL(_lib_path(name))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a nonzero ``cudaError_t`` (or one of the
    entry's own argument codes, which are negative)."""
    if err != 0:
        msg = lib.adamvs_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} (code {err})")


def bind(lib: ctypes.CDLL, fn_name: str, n_ptr: int, n_int: int):
    """Declare a C entry ``int fn(int..., void*..., void* stream)``: ``n_int``
    ints first, then ``n_ptr`` pointers, then the stream."""
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_int] * n_int + [ctypes.c_void_p] * (n_ptr + 1)
    fn.restype = ctypes.c_int
    lib.adamvs_error_string.argtypes = [ctypes.c_int]
    lib.adamvs_error_string.restype = ctypes.c_char_p
    return fn


def _cxx() -> str:
    path = shutil.which(CXX)
    if path is None:
        raise RuntimeError(f"{CXX} not found: the host library (csrc/host/) needs a C++ compiler")
    return path


def _host_lib_path(cxx: str) -> str:
    """The host library's path: a hash of its sources, the flags, and the
    compiler's version and resolved ``-march=native`` target."""
    h = hashlib.sha256()
    for f in sorted(os.listdir(HOST_SRC)):
        with open(os.path.join(HOST_SRC, f), "rb") as fh:
            h.update(f.encode() + fh.read())
    h.update(" ".join(HOST_FLAGS + HOST_LIBS).encode())
    for query in (["--version"], ["-march=native", "-Q", "--help=target"]):
        h.update(subprocess.run([cxx, *query], capture_output=True, text=True,
                                timeout=60, check=True).stdout.encode())
    return os.path.join(BUILD_DIR, f"libmvsnative-{h.hexdigest()[:16]}.so")


def build_host() -> tuple[str, bool]:
    """Build the host library unless it is built. Returns (its path, whether
    this call compiled it); raises with the compiler's output if it failed.
    Processes that build at once each compile into a temporary file and
    replace the library with it."""
    with _HOST_BUILD:
        return _build_host()


def _build_host() -> tuple[str, bool]:
    cxx = _cxx()
    out = _host_lib_path(cxx)
    if os.path.exists(out):
        return out, False
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    srcs = sorted(os.path.join(HOST_SRC, f) for f in os.listdir(HOST_SRC) if f.endswith(".cc"))
    try:
        proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, *srcs, *HOST_LIBS],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed for csrc/host/ (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, True
