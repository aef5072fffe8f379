"""ctypes binding to the repository's native C++ geometry library (``native/``).

Counterpart of ``actionmesh_tpu/utils/native.py``, binding what the port
calls: ``marching_cubes_grid`` and ``marching_tetrahedra_grid``
(triangulation of the hierarchical SDF lattice), ``marching_cubes_cells``
and ``marching_tetrahedra_cells`` (of pre-filtered crossing cells: the dense
single-level extraction), ``quadric_decimate`` (QEM edge collapse),
``grid_cluster_simplify`` (its clustering pre-pass) and
``rasterize_zbuffer`` (the preview renderer's visibility pass). Beside it,
the port's own ``csrc/png_unfilter.cpp`` (``png_unfilter``, for
``io/png.py``) is built and loaded the same way.

``native/actionmesh_native.cpp`` is compiled with g++, with the flags of
``native/build.sh``, into ``actionmesh_tpu_torch/_build/
actionmesh_native-<hash>.so``, keyed by a hash of the source,
``native/mc_table.h``, the flags and the target that ``-march=native``
resolves to on this host (a build directory copied to another CPU is then
rebuilt, not loaded), at first use; nothing is written into ``native/``. A
failed build raises: there is no numpy fallback, because another
triangulation or decimation algorithm would change the anchor mesh.
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

from actionmesh_tpu_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR, PACKAGE_DIR, build_lock

NATIVE_DIR = PACKAGE_DIR.parent / "native"
SOURCE = NATIVE_DIR / "actionmesh_native.cpp"
HEADERS = (NATIVE_DIR / "mc_table.h",)
PNG_SOURCE = CSRC_DIR / "png_unfilter.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_png_lib = None


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


def library_path(source: Path = SOURCE, headers: tuple = HEADERS) -> Path:
    """Where ``source`` builds to, keyed by it, its headers, the flags and
    the host's target."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(host_target().encode())
    for path in (source, *headers):
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, headers: tuple = HEADERS) -> Path:
    """Compile ``source`` unless it is built already (under its
    ``build_lock``: one process builds, the others wait); return its path."""
    lib_path = library_path(source, headers)
    if lib_path.exists():
        return lib_path
    with build_lock(lib_path):
        if lib_path.exists():  # built by another process while this one waited
            return lib_path
        # build under a temporary name, then rename: never a half-written .so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run(
            [find_cxx(), *CXX_FLAGS, str(source), "-o", tmp], capture_output=True, text=True
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed for {source} ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
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
    for name in ("marching_cubes_grid", "marching_tetrahedra_grid"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float), i64p, ctypes.c_int64, ctypes.c_int64,
            f64p, f64p, ctypes.c_double, ctypes.c_int64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            i64p,
        ]
    for name in ("marching_cubes_cells", "marching_tetrahedra_cells"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int64
        fn.argtypes = [
            f64p, ctypes.POINTER(ctypes.c_float), i64p, ctypes.c_int64, ctypes.c_double,
            f64p, ctypes.c_int64, i64p, ctypes.c_int64, i64p,
        ]
    lib.am_free.restype = None
    lib.am_free.argtypes = [ctypes.c_void_p]
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    lib.rasterize_zbuffer.restype = None
    lib.rasterize_zbuffer.argtypes = [
        f32p, f32p, f32p, ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
        i32p, f32p,
    ]
    _lib = lib
    return lib


def _load_png() -> ctypes.CDLL:
    global _png_lib
    if _png_lib is None:
        lib = ctypes.CDLL(str(build(PNG_SOURCE, ())))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.png_unfilter.restype = ctypes.c_int64
        lib.png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, u8p]
        _png_lib = lib
    return _png_lib


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


WELD_ID_LIMIT = 2**31  # the native weld key packs two lattice ids into 64 bits


def _marching_grid(fn_name, fine_vals, cell_ijk, lo, cell_size, fine_R, level):
    lib = _load()
    if fine_vals.ndim != 4 or len(cell_ijk) != len(fine_vals):
        raise ValueError(
            f"{fn_name}: fine_vals (C, s+1, s+1, s+1) and cell_ijk (C, 3), "
            f"got {fine_vals.shape} {np.shape(cell_ijk)}"
        )
    if fine_R ** 3 >= WELD_ID_LIMIT:
        raise ValueError(f"{fn_name}: fine_R {fine_R} exceeds the weld-key range")
    fv = np.ascontiguousarray(fine_vals, np.float32)
    cij = np.ascontiguousarray(cell_ijk, np.int64)
    lo = np.ascontiguousarray(lo, np.float64)
    cs = np.ascontiguousarray(cell_size, np.float64)
    verts_ptr = ctypes.POINTER(ctypes.c_float)()
    faces_ptr = ctypes.POINTER(ctypes.c_int32)()
    out_nv = ctypes.c_int64(0)
    nf = getattr(lib, fn_name)(
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
    return _marching_grid("marching_cubes_grid", fine_vals, cell_ijk, lo, cell_size, fine_R, level)


def marching_tetrahedra_grid(
    fine_vals: np.ndarray,
    cell_ijk: np.ndarray,
    lo: np.ndarray,
    cell_size: np.ndarray,
    fine_R: int,
    level: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Marching tetrahedra (six tetrahedra a cube about its 0-7 diagonal)
    over hierarchical fine lattices; the contract of
    ``marching_cubes_grid``, with vertices also on face and body diagonals."""
    return _marching_grid("marching_tetrahedra_grid", fine_vals, cell_ijk, lo, cell_size, fine_R, level)


def _marching_cells(fn_name, corner_points, corner_values, corner_ids, level):
    lib = _load()
    cp = np.ascontiguousarray(corner_points, np.float64)
    cv = np.ascontiguousarray(corner_values, np.float32)
    cid = np.ascontiguousarray(corner_ids, np.int64)
    C = len(cp)
    if cp.shape != (C, 8, 3) or cv.shape != (C, 8) or cid.shape != (C, 8):
        raise ValueError(
            f"{fn_name}: corner_points (C, 8, 3), corner_values and corner_ids (C, 8), "
            f"got {cp.shape} {cv.shape} {cid.shape}"
        )
    if cid.size and (cid.min() < 0 or cid.max() >= WELD_ID_LIMIT):
        raise ValueError(f"{fn_name}: corner ids outside the weld-key range [0, 2^31)")
    verts_cap, faces_cap = 8 * C + 16, 12 * C + 16
    out_v = np.empty((verts_cap, 3), np.float64)
    out_f = np.empty((faces_cap, 3), np.int64)
    out_nv = ctypes.c_int64(0)
    nf = getattr(lib, fn_name)(
        _ptr(cp, ctypes.c_double), _ptr(cv, ctypes.c_float), _ptr(cid, ctypes.c_int64), C,
        float(level), _ptr(out_v, ctypes.c_double), verts_cap, _ptr(out_f, ctypes.c_int64),
        faces_cap, ctypes.byref(out_nv),
    )
    if nf < 0:
        raise RuntimeError(f"{fn_name}: output capacity exceeded")
    return out_v[: out_nv.value].astype(np.float32), out_f[:nf].copy()


def marching_cubes_cells(
    corner_points: np.ndarray,
    corner_values: np.ndarray,
    corner_ids: np.ndarray,
    level: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Marching cubes (the generated table of ``native/mc_table.h``) over
    pre-filtered crossing cells: corner_points (C, 8, 3), corner_values
    (C, 8), corner_ids (C, 8) globally unique lattice ids below 2^31 (the
    exact vertex welding keys on them). Returns (vertices (V, 3) float32,
    faces (F, 3) int64)."""
    return _marching_cells("marching_cubes_cells", corner_points, corner_values, corner_ids, level)


def marching_tetrahedra_cells(
    corner_points: np.ndarray,
    corner_values: np.ndarray,
    corner_ids: np.ndarray,
    level: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Marching tetrahedra over pre-filtered crossing cells; the contract
    of ``marching_cubes_cells``."""
    return _marching_cells("marching_tetrahedra_cells", corner_points, corner_values, corner_ids, level)


def rasterize_zbuffer(
    px: np.ndarray,
    py: np.ndarray,
    z: np.ndarray,
    faces: np.ndarray,
    size: int,
    near: float = 1e-4,
) -> tuple[np.ndarray, np.ndarray]:
    """C++ z-buffer visibility pass of the preview renderer.

    Screen-space x, y and camera depth per vertex (V,), faces (F, 3), the
    (supersampled) image size. Returns win_fid (size*size,) int32, -1 for
    background, and win_bary (size*size, 3) float32, the perspective-correct
    barycentrics of the winning face's sample.
    """
    lib = _load()
    px = np.ascontiguousarray(px, np.float32)
    py = np.ascontiguousarray(py, np.float32)
    z = np.ascontiguousarray(z, np.float32)
    f = np.ascontiguousarray(faces, np.int32)
    if not (px.shape == py.shape == z.shape and px.ndim == 1) or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(
            f"rasterize_zbuffer: px, py, z (V,) and faces (F, 3), got {px.shape} {py.shape} "
            f"{z.shape} {f.shape}"
        )
    if f.size and (f.min() < 0 or f.max() >= len(px)):
        raise ValueError(f"rasterize_zbuffer: face indices outside [0, {len(px)})")
    win_fid = np.empty(size * size, np.int32)
    win_bary = np.empty((size * size, 3), np.float32)
    lib.rasterize_zbuffer(
        _ptr(px, ctypes.c_float), _ptr(py, ctypes.c_float), _ptr(z, ctypes.c_float), len(px),
        _ptr(f, ctypes.c_int32), len(f), int(size), float(near),
        _ptr(win_fid, ctypes.c_int32), _ptr(win_bary, ctypes.c_float),
    )
    return win_fid, win_bary


def png_unfilter(data: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo PNG filter method 0: ``data`` holds ``height`` rows of a
    filter-type byte and ``stride`` filtered bytes; returns (height, stride)
    uint8. ``bpp`` is the bytes of one complete pixel (at least 1)."""
    buf = np.ascontiguousarray(data, np.uint8)
    if buf.size != height * (stride + 1):
        raise ValueError(
            f"png_unfilter: {buf.size} bytes of image data, expected {height} rows of "
            f"1 + {stride} bytes"
        )
    out = np.empty((height, stride), np.uint8)
    bad = _load_png().png_unfilter(_ptr(buf, ctypes.c_uint8), height, stride, bpp,
                                   _ptr(out, ctypes.c_uint8))
    if bad:
        raise ValueError(f"PNG: unknown filter type in row {bad - 1}")
    return out
