"""Build CUDA sources of the port into shared libraries and load them.

``nvcc`` compiles ``csrc/<name>.cu`` for ``sm_90a`` (Hopper) into
``actionmesh_tpu_torch/_build/<name>-<hash>.so``, keyed by a hash of the
source and the shared headers (``csrc/*.cuh``), at first use. The library
exposes a plain C interface and is loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds, not minutes. ``build`` starts one
``nvcc`` per source, all at once, with ``-Xptxas -v``; ``ptxas_report``
reads each kernel's registers and spills from what ptxas printed. A build
holds a file lock on its ``.so`` (``build_lock``), so the ranks of a
distributed job that all reach a kernel first at once build it once: the
others wait, then load what the first built.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
SOURCES = ("flash_fwd", "flash_bwd", "nn_argmin", "rms_rope")

_loaded: dict[str, ctypes.CDLL] = {}
ptxas_output: dict[str, str] = {}  # source name -> ptxas -v output of its last build here


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


@contextlib.contextmanager
def build_lock(lib_path: Path):
    """Hold an exclusive lock on ``<lib_path>.lock`` (released when the
    process ends, however it ends)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(f"{lib_path}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(names=SOURCES) -> None:
    """Compile every source in ``names`` that is not built yet, in parallel,
    each under its ``build_lock`` (taken in the order of ``names``)."""
    with contextlib.ExitStack() as locks:
        _build_locked(names, locks)


def _build_locked(names, locks: contextlib.ExitStack) -> None:
    jobs = []
    for name in names:
        lib_path = library_path(name)
        if lib_path.exists():
            continue
        locks.enter_context(build_lock(lib_path))
        if lib_path.exists():  # built by another process while this one waited
            continue
        # build under a temporary name, then rename: never a half-written .so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src = CSRC_DIR / f"{name}.cu"
        cmd = [
            find_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(src),
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
            ptxas_output[src.stem] = out + err
    if failures:
        raise RuntimeError("\n".join(failures))


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def _kernel_name(mangled: str) -> str:
    """``name<args>`` from an Itanium-mangled kernel name such as
    ``_ZN12_GLOBAL__N_125flash_bwd_dkv_bf16_kernelILi128EEv...``: the last
    component of the (nested) name and its template arguments (integers,
    booleans, float and named types)."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    i, name = m.end(), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j : j + int(mangled[i:j])], j + int(mangled[i:j])
    if not mangled.startswith("I", i):
        return name
    args, i = [], i + 1
    while i < len(mangled) and mangled[i] != "E":
        lit = re.match(r"Li(\d+)E|Lb([01])E|(\d+)|f", mangled[i:])
        if lit is None:
            break
        if lit.group(1):
            args.append(lit.group(1))
            i += lit.end()
        elif lit.group(2):
            args.append("true" if lit.group(2) == "1" else "false")
            i += lit.end()
        elif lit.group(3):
            n = int(lit.group(3))
            args.append(mangled[i + lit.end() : i + lit.end() + n])
            i += lit.end() + n
        else:
            args.append("float")
            i += 1
    return f"{name}<{', '.join(args)}>"


def ptxas_report(text: str) -> list[dict]:
    """Registers and spill bytes of each entry function in ``ptxas -v``
    output, named as ``flash_bwd_dq_bf16_kernel<128>``."""
    rows = []
    for block in text.split("Compiling entry function")[1:]:
        block = "Compiling entry function" + block
        name = _kernel_name(_ENTRY.search(block).group(1))
        spills, regs = _SPILLS.search(block), _REGS.search(block)
        rows.append({
            "kernel": name,
            "registers": int(regs.group(1)) if regs else None,
            "spill_store_bytes": int(spills.group(1)) if spills else None,
            "spill_load_bytes": int(spills.group(2)) if spills else None,
        })
    return rows


def load_library(name: str) -> ctypes.CDLL:
    """Compile (once per source hash) and load ``csrc/<name>.cu``."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
