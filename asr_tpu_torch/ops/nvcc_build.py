"""Build a hand-written CUDA source into a shared library with nvcc.

Each kernel source under ``asr_tpu_torch/csrc`` (:data:`SOURCES`, seven of
them: the int8, packed-int4 and packed-int2 matmuls and the four fused
decode steps) has a plain C interface and
is compiled at first use (``sm_90a``) into ``asr_tpu_torch/_build/``, then
loaded with ``ctypes``. The library name carries a hash of the source, the
headers beside it (``csrc/*.cuh``, which the sources include) and the flags,
so a stale build is never loaded; a file lock serializes concurrent
builds.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build(source: Path, flags: tuple[str, ...] = NVCC_FLAGS, salt: str = "") -> tuple[Path, str]:
    """Compile ``source`` once per content (its headers too) and flags; return
    (library, nvcc log). A non-empty ``salt`` enters the hash, so the same
    source builds into a second library of its own (the check that two
    libraries of one design work side by side in one process)."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags).encode())
    if salt:
        h.update(b"salt:" + salt.encode())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    log = lib.with_suffix(".log")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{source.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            proc = subprocess.run([find_nvcc(), *flags, "-o", str(tmp), str(source)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            log.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, lib)
    return lib, log.read_text() if log.exists() else ""
