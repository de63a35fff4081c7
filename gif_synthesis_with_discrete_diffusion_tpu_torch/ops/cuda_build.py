"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each source is a plain ``extern "C"`` launcher, so nvcc builds it in seconds
without PyTorch's headers. A library may take more than one source, each a
translation unit of its own compiled in parallel, then linked. The shared
library goes to ``_build/`` inside the package (listed in ``.gitignore``),
under a name that carries a hash of the sources and the flags: a stale build
is never loaded. Nothing is built at import; the first call of :func:`load`
builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build", "load"]

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


def build(sources, out: str | os.PathLike,
          flags: tuple[str, ...] = NVCC_FLAGS) -> str:
    """nvcc ``sources`` into the shared library ``out``: one source in one
    call; more as one translation unit each, compiled in parallel (one nvcc
    a source) and linked. Returns nvcc's output; raises naming the source
    whose build failed."""
    nvcc = find_nvcc()
    sources = [Path(s) for s in sources]
    if len(sources) == 1:
        cmds = [[nvcc, *flags, "-o", str(out), str(sources[0])]]
    else:
        cmds = [[nvcc, *(f for f in flags if f != "-shared"), "-c", "-o",
                 f"{out}.{i}.o", str(src)] for i, src in enumerate(sources)]
    with ThreadPoolExecutor(len(cmds)) as pool:
        procs = list(pool.map(lambda c: subprocess.run(
            c, capture_output=True, text=True), cmds))
    log = "".join(p.stdout + p.stderr for p in procs)
    try:
        for src, proc in zip(sources, procs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n"
                                   f"{proc.stderr}")
        if len(sources) > 1:
            proc = subprocess.run(
                [nvcc, *flags, "-o", str(out),
                 *(c[-2] for c in cmds)], capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed linking {out}:\n"
                                   f"{proc.stderr}")
    finally:
        if len(sources) > 1:
            for c in cmds:
                Path(c[-2]).unlink(missing_ok=True)
    return log


def load(source: str, build_dir: str | os.PathLike | None = None,
         defines: tuple[str, ...] = (), units: tuple[str, ...] = ()
         ) -> ctypes.CDLL:
    """Build ``csrc/<source>`` and the further sources ``units`` (each a
    translation unit of its own, linked into the same library; once per
    content and flags) into ``build_dir`` (default :data:`BUILD_DIR`) and
    load it. Callers keep the library they get (one load per process).
    ``defines`` (``"NAME=VALUE"``) are passed to the preprocessor: a variant
    of the source, built beside the plain one.

    The library carries two attributes for reports: ``build_seconds`` (0.0
    when an existing build was loaded) and ``build_log`` (nvcc's output,
    with ``-Xptxas -v``'s registers and shared memory per kernel)."""
    srcs = [CSRC / s for s in (source, *units)]
    flags = NVCC_FLAGS + tuple("-D" + d for d in defines)
    # the headers under csrc/ are part of every source's content
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(b"".join(s.read_bytes() for s in srcs) + headers
                            + "\0".join(flags).encode()).hexdigest()[:16]
    build_dir = Path(build_dir) if build_dir is not None else BUILD_DIR
    lib_path = build_dir / f"lib{srcs[0].stem}_{digest}.so"
    log_path = lib_path.with_suffix(".log")
    seconds = 0.0
    if not lib_path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            log = build(srcs, tmp, flags)
        except RuntimeError:
            os.unlink(tmp)
            raise
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.build_seconds = seconds
    lib.build_log = log_path.read_text() if log_path.exists() else ""
    return lib
