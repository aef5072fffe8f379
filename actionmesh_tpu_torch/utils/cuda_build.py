"""Build CUDA sources of the port into shared libraries and load them.

``nvcc`` compiles ``csrc/<name>.cu`` for ``sm_90a`` (Hopper) into
``actionmesh_tpu_torch/_build/<name>-<hash>.so``, keyed by a hash of the
source and the shared headers (``csrc/*.cuh``), at first use. The library
exposes a plain C interface and is loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds, not minutes. ``build`` starts one
``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
SOURCES = ("flash_fwd", "flash_bwd", "nn_argmin")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME or /usr/local/cuda; raise if absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA toolkit is needed to build the port's kernels"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its and the headers' bytes."""
    digest = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for path in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> None:
    """Compile every source in ``names`` that is not built yet, in parallel."""
    jobs = []
    for name in names:
        lib_path = library_path(name)
        if lib_path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build under a temporary name, then rename: never a half-written .so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src = CSRC_DIR / f"{name}.cu"
        cmd = [
            find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-o", tmp, str(src),
        ]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        jobs.append((src, lib_path, tmp, proc))
    failures = []
    for src, lib_path, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed for {src} ({proc.returncode}):\n{out}\n{err}")
        else:
            os.replace(tmp, lib_path)
    if failures:
        raise RuntimeError("\n".join(failures))


def load_library(name: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load ``csrc/<name>.cu``."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
