"""First-party Wavefront OBJ loader (numpy; a copy of `mcpt_tpu/io/obj.py`).

Replaces the *capability* of the reference's vendored Bly7 OBJ_Loader
(`src/OBJ_Loader.hpp:363` `LoadFile`, consumed by the mesh constructor at
`src/Triangle.hpp:83-135`): positions, texture coordinates, normals, and
fan-triangulation of polygonal faces. The consumer only needs flat per-face
vertex triplets, so that is what we produce — contiguous arrays, no objects.
"""

import numpy as np


def _parse_index(token: str, count: int) -> int:
    """OBJ indices are 1-based; negatives are relative to the end."""
    i = int(token)
    return i - 1 if i > 0 else count + i


def load_obj(path):
    """Parse an OBJ file into flat per-face-vertex arrays.

    Returns a dict:
      positions: (F, 3, 3) float32 — triangle vertices (fan-triangulated)
      texcoords: (F, 3, 2) float32 — zeros where the file has no `vt`
      normals:   (F, 3, 3) float32 — zeros where the file has no `vn`
    """
    vs: list[tuple[float, float, float]] = []
    vts: list[tuple[float, float]] = []
    vns: list[tuple[float, float, float]] = []
    corners: list[tuple[int, int, int]] = []  # (v, vt, vn) indices, -1 = absent

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v" and len(parts) >= 4:
                vs.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt" and len(parts) >= 3:
                vts.append((float(parts[1]), float(parts[2])))
            elif tag == "vn" and len(parts) >= 4:
                vns.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "f" and len(parts) >= 4:
                face = []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    vi = _parse_index(fields[0], len(vs))
                    ti = (
                        _parse_index(fields[1], len(vts))
                        if len(fields) > 1 and fields[1]
                        else -1
                    )
                    ni = (
                        _parse_index(fields[2], len(vns))
                        if len(fields) > 2 and fields[2]
                        else -1
                    )
                    face.append((vi, ti, ni))
                # Fan triangulation, same as the reference loader's output
                # order for convex polygons.
                for k in range(1, len(face) - 1):
                    corners.extend((face[0], face[k], face[k + 1]))

    f_count = len(corners) // 3
    positions = np.zeros((f_count, 3, 3), dtype=np.float32)
    texcoords = np.zeros((f_count, 3, 2), dtype=np.float32)
    normals = np.zeros((f_count, 3, 3), dtype=np.float32)
    v_arr = np.asarray(vs, dtype=np.float32) if vs else np.zeros((0, 3), np.float32)
    vt_arr = np.asarray(vts, dtype=np.float32) if vts else np.zeros((0, 2), np.float32)
    vn_arr = np.asarray(vns, dtype=np.float32) if vns else np.zeros((0, 3), np.float32)
    for i, (vi, ti, ni) in enumerate(corners):
        positions[i // 3, i % 3] = v_arr[vi]
        if ti >= 0:
            texcoords[i // 3, i % 3] = vt_arr[ti]
        if ni >= 0:
            normals[i // 3, i % 3] = vn_arr[ni]
    return {"positions": positions, "texcoords": texcoords, "normals": normals}
