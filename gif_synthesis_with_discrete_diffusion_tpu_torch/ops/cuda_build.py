"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each source is a plain ``extern "C"`` launcher, so nvcc builds it in seconds
without PyTorch's headers. The shared library goes to ``_build/`` inside the
package (listed in ``.gitignore``), under a name that carries a hash of the
source and the flags: a stale build is never loaded. Nothing is built at
import; the first call of :func:`load` builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME/bin (PyTorch's own search, which
    also tries the toolkit's default prefix). Raises if there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def load(source: str, build_dir: str | os.PathLike | None = None,
         defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<source>`` (once per content and flags) into
    ``build_dir`` (default :data:`BUILD_DIR`) and load it. Callers keep the
    library they get (one load per process). ``defines`` (``"NAME=VALUE"``)
    are passed to the preprocessor: a variant of the source, built beside
    the plain one.

    The library carries two attributes for reports: ``build_seconds`` (0.0
    when an existing build was loaded) and ``build_log`` (nvcc's output,
    with ``-Xptxas -v``'s registers and shared memory per kernel)."""
    src = CSRC / source
    nvcc = find_nvcc()
    flags = NVCC_FLAGS + tuple("-D" + d for d in defines)
    # the headers under csrc/ are part of every source's content
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + "\0".join(flags).encode()).hexdigest()[:16]
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    lib_path = build_dir / f"lib{src.stem}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.build_seconds = seconds
    lib.build_log = log_path.read_text() if log_path.exists() else ""
    return lib
