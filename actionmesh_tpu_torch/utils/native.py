"""ctypes binding to the repository's native C++ geometry library (``native/``).

Counterpart of ``actionmesh_tpu/utils/native.py``, binding only what Stage 0
calls: ``marching_cubes_grid`` (triangulation of the hierarchical SDF
lattice), ``quadric_decimate`` (QEM edge collapse) and
``grid_cluster_simplify`` (its clustering pre-pass).

``native/actionmesh_native.cpp`` is compiled with g++, with the flags of
``native/build.sh``, into ``actionmesh_tpu_torch/_build/
actionmesh_native-<hash>.so``, keyed by a hash of the source,
``native/mc_table.h``, the flags and the target that ``-march=native``
resolves to on this host (a build directory copied to another CPU is then
rebuilt, not loaded), at first use; nothing is written into ``native/``. A failed build raises: there is no numpy fallback, because
another triangulation or decimation algorithm would change the anchor mesh.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from actionmesh_tpu_torch.utils.cuda_build import BUILD_DIR, PACKAGE_DIR

NATIVE_DIR = PACKAGE_DIR.parent / "native"
SOURCE = NATIVE_DIR / "actionmesh_native.cpp"
HEADERS = (NATIVE_DIR / "mc_table.h",)
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lib = None


def find_cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: it is needed to build native/actionmesh_native.cpp")
    return found


@functools.lru_cache(maxsize=None)
def host_target() -> str:
    """The target options ``-march=native`` stands for with this host's CPU
    and compiler, as ``g++ -march=native -Q --help=target`` lists them."""
    return subprocess.run(
        [find_cxx(), "-march=native", "-Q", "--help=target"],
        capture_output=True, text=True, check=True,
    ).stdout


def library_path() -> Path:
    """Where the library builds to, keyed by the source, header, flags and
    the host's target."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(host_target().encode())
    for path in (SOURCE, *HEADERS):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"actionmesh_native-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built already; return its path."""
    lib_path = library_path()
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name, then rename: never a half-written .so
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [find_cxx(), *CXX_FLAGS, str(SOURCE), "-o", tmp], capture_output=True, text=True
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f64p, i64p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    lib.quadric_decimate.restype = ctypes.c_int64
    lib.quadric_decimate.argtypes = [f64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64, f64p, i64p, i64p]
    lib.grid_cluster_simplify.restype = ctypes.c_int64
    lib.grid_cluster_simplify.argtypes = [f64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64, f64p, i64p, i64p]
    lib.marching_cubes_grid.restype = ctypes.c_int64
    lib.marching_cubes_grid.argtypes = [
        ctypes.POINTER(ctypes.c_float), i64p, ctypes.c_int64, ctypes.c_int64,
        f64p, f64p, ctypes.c_double, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        i64p,
    ]
    lib.am_free.restype = None
    lib.am_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _simplify(fn_name: str, vertices, faces, arg: int) -> tuple[np.ndarray, np.ndarray]:
    lib = _load()
    v = np.ascontiguousarray(vertices, np.float64)
    f = np.ascontiguousarray(faces, np.int64)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"{fn_name}: vertices (V, 3) and faces (F, 3), got {v.shape} {f.shape}")
    if f.size and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError(f"{fn_name}: face indices outside [0, {len(v)})")
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    out_nv = ctypes.c_int64(0)
    nf = getattr(lib, fn_name)(
        _ptr(v, ctypes.c_double), len(v), _ptr(f, ctypes.c_int64), len(f), int(arg),
        _ptr(out_v, ctypes.c_double), _ptr(out_f, ctypes.c_int64), ctypes.byref(out_nv),
    )
    return out_v[: out_nv.value].copy(), out_f[:nf].copy()


def quadric_decimate(
    vertices: np.ndarray, faces: np.ndarray, target_faces: int
) -> tuple[np.ndarray, np.ndarray]:
    """QEM edge-collapse decimation to ~target_faces."""
    return _simplify("quadric_decimate", vertices, faces, target_faces)


def grid_cluster_simplify(
    vertices: np.ndarray, faces: np.ndarray, res: int
) -> tuple[np.ndarray, np.ndarray]:
    """Uniform-grid vertex clustering to a res^3 lattice (pre-simplifier)."""
    return _simplify("grid_cluster_simplify", vertices, faces, res)


def marching_cubes_grid(
    fine_vals: np.ndarray,
    cell_ijk: np.ndarray,
    lo: np.ndarray,
    cell_size: np.ndarray,
    fine_R: int,
    level: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Marching cubes over hierarchical fine lattices.

    fine_vals (C, s+1, s+1, s+1) float32 field values at each coarse
    cell's fine sub-lattice; cell_ijk (C, 3) coarse cell coordinates.
    Positions and global weld ids derive inside; returns (vertices (V, 3)
    float32, faces (F, 3) int64).
    """
    lib = _load()
    if fine_vals.ndim != 4 or len(cell_ijk) != len(fine_vals):
        raise ValueError(
            f"marching_cubes_grid: fine_vals (C, s+1, s+1, s+1) and cell_ijk (C, 3), "
            f"got {fine_vals.shape} {np.shape(cell_ijk)}"
        )
    if fine_R ** 3 >= 2 ** 31:
        raise ValueError(f"marching_cubes_grid: fine_R {fine_R} exceeds the weld-key range")
    fv = np.ascontiguousarray(fine_vals, np.float32)
    cij = np.ascontiguousarray(cell_ijk, np.int64)
    lo = np.ascontiguousarray(lo, np.float64)
    cs = np.ascontiguousarray(cell_size, np.float64)
    verts_ptr = ctypes.POINTER(ctypes.c_float)()
    faces_ptr = ctypes.POINTER(ctypes.c_int32)()
    out_nv = ctypes.c_int64(0)
    nf = lib.marching_cubes_grid(
        _ptr(fv, ctypes.c_float), _ptr(cij, ctypes.c_int64), len(fv), fv.shape[1] - 1,
        _ptr(lo, ctypes.c_double), _ptr(cs, ctypes.c_double), float(level), int(fine_R),
        ctypes.byref(verts_ptr), ctypes.byref(faces_ptr), ctypes.byref(out_nv),
    )
    try:
        if nf == 0 or not verts_ptr:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
        v = np.ctypeslib.as_array(verts_ptr, shape=(out_nv.value, 3)).copy()
        f = np.ctypeslib.as_array(faces_ptr, shape=(nf, 3)).astype(np.int64)
    finally:
        if verts_ptr:
            lib.am_free(verts_ptr)
        if faces_ptr:
            lib.am_free(faces_ptr)
    return v, f
