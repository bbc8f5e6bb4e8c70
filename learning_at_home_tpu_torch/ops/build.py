"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel library is one ``csrc/*.cu`` file with a plain C entry point.
It is compiled at first use for ``sm_90a`` into ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), under a name keyed by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  :func:`build_all` starts one ``nvcc`` per
library, all at once, and waits for them together.  Processes that build
at once (the ranks of a job on one host) take turns on a file lock in the
build directory: the first compiles, the others then find its libraries;
each library lands by an atomic rename, so a reader never sees half of
one.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# where the CUDA toolkit puts nvcc when it is not on PATH
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
# library name -> its sources under csrc/
LIBRARIES = {
    "flash_attn_fwd": ("flash_attn_fwd.cu",),
    "flash_attn_bwd": ("flash_attn_bwd.cu",),
    "fused_ce_fwd": ("fused_ce_fwd.cu",),
    "fused_ce": ("fused_ce.cu",),
    "token_dispatch": ("token_dispatch.cu",),
}

_loaded: dict[str, ctypes.CDLL] = {}
# library name -> nvcc's stderr (the ptxas report), for the libraries this
# process compiled
build_reports: dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists(DEFAULT_NVCC):
        path = DEFAULT_NVCC
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):  # headers included by any source
        h.update(f.name.encode())
        h.update(f.read_bytes())
    for src in LIBRARIES[name]:
        h.update(src.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> None:
    """Compile every library in ``names`` (default: all) that is not built
    yet, one ``nvcc`` each, all started together.  Raises on the first
    failed compile, with the compiler's output."""
    names = list(LIBRARIES if names is None else names)
    todo = [(n, _library_path(n)) for n in names]
    if all(p.exists() for _, p in todo):
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _build_lock():
        _build([(n, p) for n, p in todo if not p.exists()])


@contextlib.contextmanager
def _build_lock():
    """The build directory's lock, held while this process compiles."""
    with open(BUILD_DIR / ".build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build(todo) -> None:
    if not todo:
        return
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in LIBRARIES[name])]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n"
                            f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial file
        build_reports[name] = stderr
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib
