"""Self-contained PLY reader/writer, numpy only (≙ irgs_tpu/utils/ply.py,
a copy: the port imports nothing of the JAX package).

Supports the subset the framework needs:
* binary_little_endian and ascii formats,
* scalar properties (float/double/int/uint/uchar/...),
* list properties (for mesh faces) with uchar count + int indices.

The Gaussian point-cloud layout matches the reference's
`GaussianModel.construct_list_of_attributes` (scene/gaussian_model.py:409-424)
so checkpoints are interchangeable at the artifact level.
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar", "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint", "float32": "float", "float64": "double",
}


@dataclass
class PlyElement:
    name: str
    count: int
    # scalar properties: list of (name, np dtype str); data: structured array
    data: np.ndarray | None = None
    # list properties: dict name -> [count] object/2D array
    lists: dict = field(default_factory=dict)


def read_ply(path: str) -> dict[str, PlyElement]:
    with open(path, "rb") as f:
        raw = f.read()
    header_end = raw.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: missing end_header")
    header = raw[:header_end].decode("ascii").splitlines()
    body = raw[header_end + len(b"end_header\n"):]

    if header[0].strip() != "ply":
        raise ValueError(f"{path}: not a PLY file")
    fmt = None
    elements: list[tuple[str, int, list]] = []
    for line in header[1:]:
        tok = line.strip().split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[4], _PLY_TO_NP[tok[2]], _PLY_TO_NP[tok[3]]))
            else:
                elements[-1][2].append(("scalar", tok[2], _PLY_TO_NP[tok[1]]))

    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"{path}: unsupported format {fmt}")

    out: dict[str, PlyElement] = {}
    if fmt == "ascii":
        text_rows = body.decode("ascii").split("\n")
        row_idx = 0
        for name, count, props in elements:
            if all(p[0] == "scalar" for p in props):
                dtype = np.dtype([(p[1], p[2]) for p in props])
                arr = np.zeros(count, dtype=dtype)
                for i in range(count):
                    vals = text_rows[row_idx].split(); row_idx += 1
                    for j, p in enumerate(props):
                        arr[p[1]][i] = float(vals[j])
                out[name] = PlyElement(name, count, arr)
            else:
                lists = {p[1]: [] for p in props if p[0] == "list"}
                for i in range(count):
                    vals = text_rows[row_idx].split(); row_idx += 1
                    k = 0
                    for p in props:
                        if p[0] == "list":
                            n = int(vals[k]); k += 1
                            lists[p[1]].append([float(v) for v in vals[k:k + n]]); k += n
                        else:
                            k += 1
                el = PlyElement(name, count)
                el.lists = {k: np.asarray(v) for k, v in lists.items()}
                out[name] = el
        return out

    # binary little endian
    buf = io.BytesIO(body)
    for name, count, props in elements:
        if all(p[0] == "scalar" for p in props):
            dtype = np.dtype([(p[1], "<" + p[2]) for p in props])
            arr = np.frombuffer(buf.read(dtype.itemsize * count), dtype=dtype, count=count)
            out[name] = PlyElement(name, count, arr)
        else:
            # mixed/list element: parse row by row (faces are small)
            lists: dict[str, list] = {p[1]: [] for p in props if p[0] == "list"}
            for _ in range(count):
                for p in props:
                    if p[0] == "list":
                        cnt_dt = np.dtype("<" + p[2])
                        n = int(np.frombuffer(buf.read(cnt_dt.itemsize), dtype=cnt_dt)[0])
                        val_dt = np.dtype("<" + p[3])
                        vals = np.frombuffer(buf.read(val_dt.itemsize * n), dtype=val_dt)
                        lists[p[1]].append(vals)
                    else:
                        dt = np.dtype("<" + p[2])
                        buf.read(dt.itemsize)
            el = PlyElement(name, count)
            el.lists = {k: np.asarray(v) for k, v in lists.items()}
            out[name] = el
    return out


def write_ply(path: str, vertex_data: np.ndarray, faces: np.ndarray | None = None,
              comments: tuple[str, ...] = ()) -> None:
    """Write a binary_little_endian PLY.

    `vertex_data` is a numpy structured array (one field per property).
    `faces` is an optional [F, 3] int array written as a vertex_indices list.
    """
    lines = ["ply", "format binary_little_endian 1.0"]
    for c in comments:
        lines.append(f"comment {c}")
    lines.append(f"element vertex {len(vertex_data)}")
    for fname in vertex_data.dtype.names:
        ply_t = _NP_TO_PLY[vertex_data.dtype[fname].name]
        lines.append(f"property {ply_t} {fname}")
    if faces is not None:
        lines.append(f"element face {len(faces)}")
        lines.append("property list uchar int vertex_indices")
    lines.append("end_header")
    header = ("\n".join(lines) + "\n").encode("ascii")

    with open(path, "wb") as f:
        f.write(header)
        f.write(vertex_data.astype(vertex_data.dtype.newbyteorder("<"), copy=False).tobytes())
        if faces is not None:
            faces = np.ascontiguousarray(faces, dtype="<i4")
            counts = np.full((len(faces), 1), 3, dtype="u1")
            rec = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
            rec["n"] = counts[:, 0]
            rec["idx"] = faces
            f.write(rec.tobytes())


def structured_from_dict(fields: dict[str, np.ndarray]) -> np.ndarray:
    """Build a structured array from {name: [N] or [N,1] float array} preserving order."""
    n = next(iter(fields.values())).shape[0]
    dtype = np.dtype([(k, "f4") for k in fields])
    arr = np.zeros(n, dtype=dtype)
    for k, v in fields.items():
        arr[k] = np.asarray(v, dtype=np.float32).reshape(n)
    return arr
