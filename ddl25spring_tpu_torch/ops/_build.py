"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, which the caller loads with
``ctypes``.  No PyTorch header is included, so a build takes seconds.  The
sources share the ``csrc/*.cuh`` headers.  Libraries go to ``_build/`` beside
this file (listed in ``.gitignore``), named by a hash of the source, the
headers and the flags: an edited source or header builds anew, an unchanged
one is reused.

Nothing here runs at import time; the first launch of a kernel builds it.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills, kept in the log
)


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the path,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        Path(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")


def library_path(source: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{key.hexdigest()[:16]}.so"


def build(*sources: Path) -> list[Path]:
    """Compile every source whose library is missing, all ``nvcc`` processes
    started together, and return the libraries' paths in order.  The compiler's
    output (with ``ptxas`` resource usage) is kept beside each library as
    ``.log``.  A failed build raises ``RuntimeError`` with that output."""
    libs = [library_path(s) for s in sources]
    todo = [(s, lib) for s, lib in zip(sources, libs) if not lib.exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        procs = []
        for src, lib in todo:
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed = []
        for lib, tmp, proc in procs:
            out, _ = proc.communicate()
            lib.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"{lib.name}: nvcc exit {proc.returncode}\n{out}")
            else:
                os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
        if failed:
            raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return libs
