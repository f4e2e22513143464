"""Build and find the port's two compiled parts: the native host core
(``native/core.cpp``, g++) and the seven CUDA kernel libraries
(``csrc/*.cu``, nvcc for ``sm_90a``). Each is a shared library with a
plain C interface, loaded with ctypes by ``native`` and ``ops/kernels``.

A library's file name carries a digest of what it is built from:
``ttpu_core-<16 hex>.so`` over ``core.cpp`` and its g++ command line,
``<kernel>-<16 hex>.so`` over the kernel's source, every ``.cuh`` of
``csrc/`` and the nvcc flags. A library of other sources is never loaded.
Each library is looked up, in order, in

1. ``PREBUILT_DIR`` (``tiktoken_tpu_torch/prebuilt/``), which a wheel
   carries: ``setup.py`` builds it with ``build_prebuilt``;
2. the loader's ``BUILD_DIR`` (``tiktoken_tpu_torch/build/``);
3. ``build/`` under the disk cache (``ops/artifacts.artifact_dir()``), or
   under the temporary directory when that cache is turned off;

and where none holds it, it is built into the first of 2 and 3 that can
be created and written. A compiler writes a temporary file, named with the
process id and a random id, that is renamed into place: processes racing
to build one library never load a half-written file.

This module imports neither torch nor any other module of the package, so
``setup.py`` loads it by its path without importing torch.
"""

from __future__ import annotations

import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import uuid

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
PREBUILT_DIR = os.path.join(PKG_DIR, "prebuilt")
CORE_SRC = os.path.join(PKG_DIR, "native", "core.cpp")
CSRC = os.path.join(PKG_DIR, "csrc")
KERNELS = ("scan_rows", "compaction", "vocab_hit", "slot_merge", "byte_scan", "grid_merge",
           "pair_count")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# where the CUDA toolkit puts nvcc; searched when nvcc is not on PATH
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def cxx_flags() -> list[str]:
    flags = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
    if platform.machine() in ("x86_64", "AMD64"):
        flags.append("-msse4.2")
    return flags


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def core_name() -> str:
    """The native core's file name. The digested command line always reads
    ``g++``, whichever compiler builds it (the interface is plain C), so a
    wheel's prebuilt core is found on a host with another compiler or
    none."""
    return f"ttpu_core-{_digest(_read(CORE_SRC) + ' '.join(['g++', *cxx_flags()]).encode())}.so"


def kernel_names() -> dict[str, str]:
    """Each kernel's library file name, by kernel: a change to any header
    of ``csrc/`` renames every kernel."""
    headers = b"".join(h.encode() + _read(os.path.join(CSRC, h))
                       for h in sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")))
    flags = " ".join(NVCC_FLAGS).encode()
    return {k: f"{k}-{_digest(_read(os.path.join(CSRC, k + '.cu')) + headers + flags)}.so"
            for k in KERNELS}


def find_nvcc() -> str | None:
    """nvcc on PATH, else at ``NVCC_DEFAULT``; None when neither exists."""
    return shutil.which("nvcc") or (NVCC_DEFAULT if os.path.exists(NVCC_DEFAULT) else None)


def cache_build_dir(cache_dir: str | None) -> str:
    """``build/`` under the disk cache ``cache_dir``, or under the temporary
    directory when the cache is turned off (None)."""
    return os.path.join(cache_dir or os.path.join(tempfile.gettempdir(),
                                                  "tiktoken-tpu-compiled-torch"), "build")


def find(name: str, build_dir: str, cache_dir: str | None) -> str | None:
    """The path of library ``name`` in the first directory of the lookup
    order that holds it; None when none does."""
    for d in (PREBUILT_DIR, build_dir, cache_build_dir(cache_dir)):
        path = os.path.join(d, name)
        if os.path.isfile(path):
            return path
    return None


def _writable(d: str) -> bool:
    """Whether ``d`` can be created and a file written in it: tried, since
    file modes do not bind root."""
    try:
        os.makedirs(d, exist_ok=True)
        fd, probe = tempfile.mkstemp(dir=d, prefix=".probe-")
    except OSError:
        return False
    os.close(fd)
    os.remove(probe)
    return True


def output_dir(build_dir: str, cache_dir: str | None) -> str:
    """The directory to build into: ``build_dir`` when it can be created
    and written, else the cache's ``build/``; raises when neither can."""
    dirs = (build_dir, cache_build_dir(cache_dir))
    for d in dirs:
        if _writable(d):
            return d
    raise RuntimeError(f"no directory to build into: neither {dirs[0]} nor {dirs[1]} can be "
                       "created and written")


def _tmp(path: str) -> str:
    return f"{path}.{os.getpid()}.{uuid.uuid4().hex}.tmp"


def build_core(cxx: str, out_dir: str) -> str:
    """Compile ``core.cpp`` with ``cxx`` into ``out_dir``; returns the
    library's path. Raises with the compiler's output when it fails."""
    so = os.path.join(out_dir, core_name())
    tmp = _tmp(so)
    cmd = [cxx, *cxx_flags()]
    proc = subprocess.run([*cmd, CORE_SRC, "-o", tmp], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building the native core failed ({' '.join(cmd)} {CORE_SRC}, exit "
                           f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, so)
    return so


def build_kernels(nvcc: str, out_dir: str, kernels=KERNELS) -> dict[str, str]:
    """Compile each of ``kernels`` into ``out_dir``, one nvcc process each,
    all started together; returns nvcc's output (its ``-Xptxas -v``
    report) by kernel. Raises with nvcc's output when one fails, after
    every process has ended."""
    names = kernel_names()
    procs = {}
    for k in kernels:
        so = os.path.join(out_dir, names[k])
        tmp = _tmp(so)
        procs[k] = (subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, k + ".cu")],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                    tmp, so)
    reports, failed = {}, []
    for k, (proc, tmp, so) in procs.items():
        reports[k], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, so)
            continue
        failed.append(k)
        if os.path.exists(tmp):
            os.remove(tmp)
    if failed:
        raise RuntimeError("".join(f"nvcc failed on csrc/{k}.cu:\n{reports[k]}" for k in failed))
    return reports


def build_prebuilt(out_dir: str) -> list[str]:
    """What a wheel carries, built into ``out_dir``: the native core with
    g++, and the seven kernel libraries where nvcc is found
    (``find_nvcc``). A compiler that is not found leaves its part out; one
    that fails raises. Returns the paths written."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    if shutil.which("g++"):
        written.append(build_core("g++", out_dir))
    nvcc = find_nvcc()
    if nvcc:
        build_kernels(nvcc, out_dir)
        written += [os.path.join(out_dir, n) for n in kernel_names().values()]
    return written
