"""Triangle mesh container (host numpy) with binary glTF (.glb) I/O.

The ``Mesh`` dataclass of ``actionmesh_tpu/io/mesh.py`` with the geometry
the pipeline needs, ``load_glb`` (every triangle primitive, node transforms
applied, TEXCOORD_0 kept as ``uv``, the file's glTF JSON and buffer kept
as the opaque ``visual``) and ``save_glb`` (positions, vertex
normals, 32-bit indices; byte for byte the JAX package's file).
"""

from __future__ import annotations

import dataclasses
import json
import struct
from pathlib import Path
from typing import Optional

import numpy as np

_GLB_MAGIC = 0x46546C67  # 'glTF'
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclasses.dataclass
class Mesh:
    """Triangle mesh: vertices (V, 3) float64, faces (F, 3) int64."""

    vertices: np.ndarray
    faces: np.ndarray
    uv: Optional[np.ndarray] = None  # (V, 2) texcoords if present
    visual: Optional[dict] = None  # opaque texture/material payload (a GLB's JSON + buffer)

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float64)
        self.faces = np.asarray(self.faces, dtype=np.int64)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_faces(self) -> int:
        return len(self.faces)

    def face_normals_and_areas(self) -> tuple[np.ndarray, np.ndarray]:
        v, f = self.vertices, self.faces
        cross = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        double_area = np.linalg.norm(cross, axis=1)
        safe = np.maximum(double_area, 1e-20)[:, None]
        return cross / safe, 0.5 * double_area

    @property
    def vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals (trimesh convention)."""
        face_normals, areas = self.face_normals_and_areas()
        weighted = face_normals * areas[:, None]
        normals = np.zeros_like(self.vertices)
        for i in range(3):
            np.add.at(normals, self.faces[:, i], weighted)
        norm = np.linalg.norm(normals, axis=1, keepdims=True)
        return normals / np.maximum(norm, 1e-20)

    @property
    def bounds(self) -> np.ndarray:
        """(2, 3): [min, max] corner."""
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    def export(self, path: str | Path) -> None:
        path = Path(path)
        if path.suffix.lower() not in (".glb", ".gltf"):
            raise ValueError(f"Unsupported mesh format: {path.suffix}")
        save_glb(self, path)


def _read_accessor(gltf: dict, binary: bytes, accessor_idx: int) -> np.ndarray:
    acc = gltf["accessors"][accessor_idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    n_comp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride")
    itemsize = np.dtype(dtype).itemsize * n_comp
    if stride is None or stride == itemsize:
        data = np.frombuffer(binary, dtype=dtype, count=count * n_comp, offset=offset)
        return data.reshape(count, n_comp) if n_comp > 1 else data
    out = np.empty((count, n_comp), dtype=dtype)
    for i in range(count):
        out[i] = np.frombuffer(binary, dtype=dtype, count=n_comp, offset=offset + i * stride)
    return out if n_comp > 1 else out[:, 0]


def _node_transform(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], dtype=np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        rot = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = rot @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def load_glb(path: str | Path) -> Mesh:
    """Load a .glb, concatenating all triangle primitives into one mesh."""
    raw = Path(path).read_bytes()
    magic, _version, _length = struct.unpack_from("<III", raw, 0)
    if magic != _GLB_MAGIC:
        raise ValueError(f"Not a GLB file: {path}")
    offset = 12
    gltf = None
    binary = b""
    while offset < len(raw):
        chunk_len, chunk_type = struct.unpack_from("<II", raw, offset)
        chunk = raw[offset + 8 : offset + 8 + chunk_len]
        if chunk_type == _CHUNK_JSON:
            gltf = json.loads(chunk)
        elif chunk_type == _CHUNK_BIN:
            binary = bytes(chunk)
        offset += 8 + chunk_len
    if gltf is None:
        raise ValueError(f"No JSON chunk in GLB: {path}")

    # walk the scene graph, collecting the world transform of each mesh instance
    nodes = gltf.get("nodes", [])
    scene = gltf.get("scenes", [{}])[gltf.get("scene", 0)]
    mesh_instances: list[tuple[int, np.ndarray]] = []

    def visit(node_idx: int, parent: np.ndarray):
        node = nodes[node_idx]
        world = parent @ _node_transform(node)
        if "mesh" in node:
            mesh_instances.append((node["mesh"], world))
        for child in node.get("children", []):
            visit(child, world)

    for root in scene.get("nodes", []):
        visit(root, np.eye(4))
    if not mesh_instances:
        mesh_instances = [(i, np.eye(4)) for i in range(len(gltf.get("meshes", [])))]

    all_verts, all_faces, all_uv = [], [], []
    v_offset = 0
    has_uv = True
    for mesh_idx, world in mesh_instances:
        for prim in gltf["meshes"][mesh_idx].get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            pos = _read_accessor(gltf, binary, prim["attributes"]["POSITION"]).astype(np.float64)
            pos = pos @ world[:3, :3].T + world[:3, 3]
            if "indices" in prim:
                faces = _read_accessor(gltf, binary, prim["indices"]).astype(np.int64).reshape(-1, 3)
            else:
                faces = np.arange(len(pos), dtype=np.int64).reshape(-1, 3)
            all_verts.append(pos)
            all_faces.append(faces + v_offset)
            if "TEXCOORD_0" in prim["attributes"]:
                all_uv.append(
                    _read_accessor(gltf, binary, prim["attributes"]["TEXCOORD_0"]).astype(np.float64)
                )
            else:
                has_uv = False
            v_offset += len(pos)

    if not all_verts:
        raise ValueError(f"No triangle geometry found in {path}")
    uv = np.concatenate(all_uv) if (has_uv and all_uv) else None
    return Mesh(
        vertices=np.concatenate(all_verts),
        faces=np.concatenate(all_faces),
        uv=uv,
        visual={"gltf": gltf, "binary": binary},
    )


def _pad4(b: bytes, fill: bytes = b"\x00") -> bytes:
    return b + fill * ((-len(b)) % 4)


def save_glb(mesh: Mesh, path: str | Path) -> None:
    verts = np.ascontiguousarray(mesh.vertices, dtype=np.float32)
    faces = np.ascontiguousarray(mesh.faces, dtype=np.uint32)
    normals = np.ascontiguousarray(mesh.vertex_normals, dtype=np.float32)

    blobs = [verts.tobytes(), normals.tobytes(), faces.tobytes()]
    views, accessors = [], []
    offset = 0
    for blob, target in zip(blobs, (34962, 34962, 34963)):  # vertex, vertex, index data
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(blob), "target": target})
        offset += len(blob)
    accessors.append({
        "bufferView": 0, "componentType": 5126, "count": len(verts), "type": "VEC3",
        "min": verts.min(axis=0).tolist(), "max": verts.max(axis=0).tolist(),
    })
    accessors.append({"bufferView": 1, "componentType": 5126, "count": len(normals), "type": "VEC3"})
    accessors.append({"bufferView": 2, "componentType": 5125, "count": faces.size, "type": "SCALAR"})

    binary = _pad4(b"".join(blobs))
    gltf = {
        # the JAX package's generator name, so both packages write the same bytes
        "asset": {"version": "2.0", "generator": "actionmesh_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2, "mode": 4}]}
        ],
        "buffers": [{"byteLength": len(binary)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    write_glb(path, gltf, binary)


def write_glb(path: str | Path, gltf: dict, binary: bytes) -> None:
    """A binary glTF file of the JSON ``gltf`` and its 4-byte padded buffer."""
    json_chunk = _pad4(json.dumps(gltf, separators=(",", ":")).encode(), b" ")
    total = 12 + 8 + len(json_chunk) + 8 + len(binary)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        f.write(struct.pack("<II", len(json_chunk), _CHUNK_JSON))
        f.write(json_chunk)
        f.write(struct.pack("<II", len(binary), _CHUNK_BIN))
        f.write(binary)


def save_textured_glb(mesh: Mesh, path: str | Path, texture: np.ndarray) -> None:
    """A .glb of ``mesh`` with its ``uv`` as TEXCOORD_0 and ``texture``
    ((H, W, 3|4) uint8) as the base-colour image of its one material:
    positions, uvs and 32-bit indices in one buffer, the PNG after them."""
    from actionmesh_tpu_torch.io.png import encode_png

    if mesh.uv is None:
        raise ValueError("save_textured_glb: the mesh has no uv")
    verts = np.ascontiguousarray(mesh.vertices, dtype=np.float32)
    uv = np.ascontiguousarray(mesh.uv, dtype=np.float32)
    faces = np.ascontiguousarray(mesh.faces, dtype=np.uint32)
    blobs = [verts.tobytes(), uv.tobytes(), faces.tobytes(), encode_png(texture)]
    views, offset = [], 0
    for blob, target in zip(blobs, (34962, 34962, 34963, None)):
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(blob)}
        if target is not None:
            view["target"] = target
        views.append(view)
        offset += len(_pad4(blob))
    binary = b"".join(_pad4(b) for b in blobs)
    gltf = {
        "asset": {"version": "2.0", "generator": "actionmesh_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                                    "indices": 2, "material": 0, "mode": 4}]}],
        "materials": [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}],
        "images": [{"bufferView": 3, "mimeType": "image/png"}],
        "buffers": [{"byteLength": len(binary)}],
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(verts), "type": "VEC3",
             "min": verts.min(axis=0).tolist(), "max": verts.max(axis=0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": len(uv), "type": "VEC2"},
            {"bufferView": 2, "componentType": 5125, "count": faces.size, "type": "SCALAR"},
        ],
    }
    write_glb(path, gltf, binary)
