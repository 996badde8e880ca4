"""Mesh extraction from the NGP density field.

Counterpart of ``sparsefusion_tpu/render/mesh.py``: a dependency-free
**marching tetrahedra** extractor (each grid cube splits into 6
tetrahedra; each tet with a sign change emits 1-2 triangles with linear
edge interpolation), a wavefront ``.obj`` writer, and a per-face chart
texture bake written as ``.obj`` + ``.mtl`` + ``.png``.

Every function runs on the device of its input: the density grid is
evaluated in chunks on ``device`` (on a CUDA device the field's encode is
kernel K1), and the extraction and the bake run there too.  The results
equal the JAX package's on the same values: the same tables, triangle
order, vertex dedupe (``round(p * 1e5)`` as int64, sorted
lexicographically, each key's first occurrence kept) and file text.

The bake keeps the JAX package's layout, in which the two faces that
share a chart cell (faces ``2c`` and ``2c + 1``) are both written over
the whole cell, so every texel holds the mean of the two faces' colours.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

# 6-tet decomposition of the unit cube (corner indices, consistent
# orientation); corner c = x + 2y + 4z
_TETS = ((0, 5, 1, 3), (0, 4, 5, 3), (4, 7, 5, 3), (4, 6, 7, 3),
         (0, 3, 2, 6), (0, 6, 4, 3))
_CORNERS = tuple((c & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8))


def _tet_triangles(inside):
    """For one sign pattern (4 bools), the triangles as edge-index pairs
    (i, j) within the tet; the crossing points become the vertices."""
    ins = [i for i in range(4) if inside[i]]
    outs = [i for i in range(4) if not inside[i]]
    if len(ins) in (0, 4):
        return []
    if len(ins) == 1:
        a = ins[0]
        b, c, d = outs
        return [((a, b), (a, c), (a, d))]
    if len(ins) == 3:
        a = outs[0]
        b, c, d = ins
        return [((b, a), (d, a), (c, a))]
    # two in, two out: a quad, two triangles
    a, b = ins
    c, d = outs
    return [((a, c), (b, c), (b, d)), ((a, c), (b, d), (a, d))]


_CASES = [_tet_triangles([(m >> i) & 1 for i in range(4)])
          for m in range(16)]


def _unique_rows(key: torch.Tensor):
    """The distinct rows of an (n, 3) int64 key in ascending lexicographic
    order, as ``np.unique(key, axis=0, return_index=True,
    return_inverse=True)`` gives them: (the first occurrence of each, the
    inverse).  Stable sorts by the last column, then the middle, then the
    first (``torch.unique(dim=0)`` takes ~36 s a 7.8M-row key on 8 CPU
    cores; these three sorts a second or two)."""
    n = len(key)
    order = torch.arange(n, device=key.device)
    for col in (2, 1, 0):
        order = order[torch.sort(key[order, col], stable=True).indices]
    sk = key[order]
    new = torch.ones(n, dtype=torch.bool, device=key.device)
    new[1:] = (sk[1:] != sk[:-1]).any(dim=1)
    inv = torch.empty_like(order)
    inv[order] = torch.cumsum(new, 0) - 1
    # stable sorts keep equal rows in their original order: each run
    # starts at its first occurrence
    return order[new], inv


def marching_tetrahedra(values: torch.Tensor, iso: float, origin, spacing
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The iso-surface of an (X, Y, Z) scalar grid, on its device.

    ``origin`` and ``spacing`` are 3-vectors (float64) mapping grid
    indices to world coordinates.  Returns (vertices (V, 3) float32,
    faces (F, 3) int32), vertices de-duplicated.  Triangles come in the
    order tet, case, the case's triangles, ascending cube index; the
    crossing parameter is computed in the grid's dtype and the
    interpolation in float64.
    """
    values = torch.as_tensor(values)
    dev = values.device
    gx, gy, gz = values.shape
    cx, cy, cz = gx - 1, gy - 1, gz - 1
    # (C, 8) corner values, cubes in C order over (x, y, z)
    corner_vals = torch.stack([
        values[dx:dx + cx, dy:dy + cy, dz:dz + cz].reshape(-1)
        for dx, dy, dz in _CORNERS], dim=-1)
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=dev)

    tris = []
    for tet in _TETS:
        tv = corner_vals[:, list(tet)]                     # (C, 4)
        inside = (tv > iso).to(torch.int32)
        case = (inside[:, 0] | (inside[:, 1] << 1) | (inside[:, 2] << 2)
                | (inside[:, 3] << 3))
        for m in range(1, 15):
            sel = torch.nonzero(case == m).squeeze(1)
            if sel.numel() == 0:
                continue
            cube = torch.stack([sel // (cy * cz), (sel // cz) % cy,
                                sel % cz], dim=-1)         # (S, 3)
            tvs = tv[sel]
            for tri in _CASES[m]:
                pts = []
                for i, j in tri:
                    vi, vj = tvs[:, i], tvs[:, j]
                    d = vj - vi
                    t = (iso - vi) / torch.where(d.abs() < 1e-12, 1e-12, d)
                    t = t.clamp(0.0, 1.0)[:, None]
                    pi = (cube + corners[tet[i]]).double()
                    pj = (cube + corners[tet[j]]).double()
                    pts.append(pi + t * (pj - pi))
                tris.append(torch.stack(pts, dim=1))       # (S, 3, 3)
    if not tris:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int32, device=dev))

    flat = torch.cat(tris).reshape(-1, 3)
    first, inv = _unique_rows(torch.round(flat * 1e5).to(torch.int64))
    verts = flat[first]
    faces = inv.reshape(-1, 3).to(torch.int32)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]
    origin = torch.as_tensor(np.asarray(origin, np.float64), device=dev)
    spacing = torch.as_tensor(np.asarray(spacing, np.float64), device=dev)
    return (origin[None] + verts * spacing[None]).float(), faces


def grid_axis(bound: float, resolution: int) -> np.ndarray:
    """The grid's coordinates along one axis, exactly as the JAX package
    makes them (``np.linspace`` in float32)."""
    return np.linspace(-bound, bound, resolution, dtype=np.float32)


@torch.no_grad()
def density_grid(field_fn: Callable, bound: float = 4.0,
                 resolution: int = 128, chunk: int = 65536,
                 device="cuda") -> torch.Tensor:
    """``field_fn`` (sigma of (n, 3) float32 points) on the
    ``resolution``^3 grid over [-bound, bound]^3, evaluated on ``device``
    in chunks of ``chunk`` points: (R, R, R) float32, x-major."""
    xs = torch.from_numpy(grid_axis(bound, resolution)).to(device)
    grid = torch.stack(torch.meshgrid(xs, xs, xs, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    values = torch.cat([field_fn(grid[i:i + chunk])
                        for i in range(0, len(grid), chunk)])
    return values.reshape(resolution, resolution, resolution)


@torch.no_grad()
def _extract(field_fn, bound, resolution, density_thresh, chunk, device):
    values = density_grid(field_fn, bound, resolution, chunk, device)
    xs = grid_axis(bound, resolution)
    spacing = np.full(3, xs[1] - xs[0], np.float64)
    origin = np.full(3, -bound, np.float64)
    return marching_tetrahedra(values, density_thresh, origin, spacing)


def _write_lines(path: str, lines) -> None:
    with open(path, "w") as fp:
        fp.write("".join(lines))


@torch.no_grad()
def export_mesh(field_fn: Callable, path: str, bound: float = 4.0,
                resolution: int = 128, density_thresh: float = 10.0,
                chunk: int = 65536, color_fn: Optional[Callable] = None,
                device="cuda"):
    """Evaluate the density field on a grid and write an ``.obj`` mesh
    (per-vertex colours from ``color_fn`` if given).  Returns (vertices,
    faces) on ``device``."""
    verts, faces = _extract(field_fn, bound, resolution, density_thresh,
                            chunk, device)
    colors = None
    if color_fn is not None and len(verts):
        colors = torch.cat([color_fn(verts[i:i + chunk])
                            for i in range(0, len(verts), chunk)])
        colors = colors.cpu().numpy()
    # numpy float32 scalars print their shortest float32 repr, as the JAX
    # writer's (a Python float would print the float64 expansion)
    v_np, f_np = verts.cpu().numpy(), faces.cpu().numpy()
    lines = []
    for i, v in enumerate(v_np):
        if colors is not None:
            c = colors[i]
            lines.append(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            lines.append(f"v {v[0]} {v[1]} {v[2]}\n")
    lines += [f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in f_np.tolist()]
    _write_lines(path, lines)
    return verts, faces


def _face_uv_layout(n_faces: int, block: int, atlas: int):
    """Per-face chart packing: two triangles per (block x block) cell.

    Returns (uvs (F, 3, 2) in [0, 1], cell origin (F, 2) texels, lower
    (F,) bool: whether the face is the lower-left triangle of its cell),
    numpy.  UV corners keep a one-texel inset.
    """
    cells_per_row = atlas // block
    face_idx = np.arange(n_faces)
    cell = face_idx // 2
    lower = (face_idx % 2) == 0
    cx = (cell % cells_per_row) * block
    cy = (cell // cells_per_row) * block
    inset = 1.0
    b = float(block)
    lo = np.array([[inset, inset], [b - inset, inset], [inset, b - inset]])
    up = np.array([[b - inset, b - inset], [inset, b - inset],
                   [b - inset, inset]])
    corners = np.where(lower[:, None, None], lo[None], up[None])
    origin = np.stack([cx, cy], axis=-1).astype(np.float64)
    uvs = (origin[:, None, :] + corners) / float(atlas)
    return uvs, origin, lower


@torch.no_grad()
def bake_texture(verts: torch.Tensor, faces: torch.Tensor, color_fn,
                 block: int = 8, chunk: int = 65536):
    """Bake per-face charts into a texture atlas on the device of
    ``verts``: one ``color_fn`` call (float32 points) per chunk of faces
    with ``chunk`` texels, over every texel's barycentric 3-D position
    (clamped into its triangle).  Each face is written over its whole
    cell, and each texel is the mean of what its cell's faces wrote.

    Returns (texture (A, A, 3) float32 in [0, 1] on the device, uvs
    (F, 3, 2) float64 numpy).
    """
    dev = verts.device
    n_faces = len(faces)
    cells = (n_faces + 1) // 2
    cells_per_row = int(np.ceil(np.sqrt(cells)))
    atlas = 1 << int(np.ceil(np.log2(max(cells_per_row * block, block))))
    uvs, origin, lower = _face_uv_layout(n_faces, block, atlas)

    # texel centres of one cell, row-major; their barycentric coordinates
    # in the lower triangle (0,0), (b,0), (0,b) and the upper (b,b),
    # (0,b), (b,0)
    ty, tx = np.meshgrid(np.arange(block), np.arange(block), indexing="ij")
    txf = tx.reshape(-1).astype(np.float64) + 0.5
    tyf = ty.reshape(-1).astype(np.float64) + 0.5
    b = float(block)
    w1_lo, w2_lo = txf / b, tyf / b
    w1_up, w2_up = 1.0 - txf / b, 1.0 - tyf / b
    bary_lo = np.stack([1.0 - w1_lo - w2_lo, w1_lo, w2_lo], axis=-1)
    bary_up = np.stack([1.0 - w1_up - w2_up, w1_up, w2_up], axis=-1)
    bary_lo, bary_up = (torch.as_tensor(a, device=dev)
                        for a in (bary_lo, bary_up))
    lower = torch.as_tensor(lower, device=dev)
    # each face's texels in the flattened atlas
    cell_texels = torch.as_tensor((ty * atlas + tx).reshape(-1), device=dev)
    texel = (torch.as_tensor(origin[:, 1] * atlas + origin[:, 0],
                             device=dev).long()[:, None] + cell_texels)

    tex = torch.zeros((atlas * atlas, 3), dtype=torch.float32, device=dev)
    wsum = torch.zeros((atlas * atlas,), dtype=torch.float32, device=dev)
    tri = verts[faces.long()]                              # (F, 3, 3)
    step = max(1, chunk // (block * block))
    for f0 in range(0, n_faces, step):
        fsl = slice(f0, min(n_faces, f0 + step))
        bary = torch.where(lower[fsl, None, None], bary_lo[None],
                           bary_up[None])                  # (f, T, 3)
        bary = bary.clamp(0.0, 1.0)
        bary = bary / bary.sum(-1, keepdim=True).clamp(min=1e-8)
        t = tri[fsl].double()
        pts = (bary[..., 0, None] * t[:, None, 0]
               + bary[..., 1, None] * t[:, None, 1]
               + bary[..., 2, None] * t[:, None, 2])       # (f, T, 3)
        cols = color_fn(pts.reshape(-1, 3).float())
        idx = texel[fsl].reshape(-1)
        tex.index_add_(0, idx, cols.reshape(-1, 3).float())
        wsum.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    tex = tex / wsum.clamp(min=1.0)[:, None]
    return tex.clamp(0.0, 1.0).reshape(atlas, atlas, 3), uvs


def write_png(path: str, image: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (stdlib only)."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    h, w, _ = image.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          image.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))


@torch.no_grad()
def export_mesh_textured(field_fn: Callable, color_fn: Callable, path: str,
                         bound: float = 4.0, resolution: int = 128,
                         density_thresh: float = 10.0, chunk: int = 65536,
                         block: int = 8, device="cuda"):
    """Textured export: ``.obj`` with per-face UVs, ``.mtl`` and the baked
    ``.png`` atlas.  Returns (vertices, faces, texture), the texture None
    when the mesh has no faces (then only a plain ``.obj`` is written)."""
    base = path[:-4] if path.endswith(".obj") else path
    name = os.path.basename(base)
    verts, faces = _extract(field_fn, bound, resolution, density_thresh,
                            chunk, device)
    v_np, f_np = verts.cpu().numpy(), faces.cpu().numpy()
    if not len(faces):
        _write_lines(base + ".obj", [f"v {v[0]} {v[1]} {v[2]}\n"
                                     for v in v_np])
        return verts, faces, None

    tex, uvs = bake_texture(verts, faces, color_fn, block=block, chunk=chunk)
    # PNG row 0 is the top; the OBJ v-coordinate 0 is the bottom
    write_png(base + ".png",
              (tex.flip(0) * 255).to(torch.uint8).cpu().numpy())
    _write_lines(base + ".mtl",
                 [f"newmtl {name}\nKd 1.0 1.0 1.0\nmap_Kd {name}.png\n"])
    lines = [f"mtllib {name}.mtl\nusemtl {name}\n"]
    lines += [f"v {v[0]} {v[1]} {v[2]}\n" for v in v_np]
    # float64 and int values print as numpy's do through Python's repr
    lines += [f"vt {u} {v}\n" for u, v in uvs.reshape(-1, 2).tolist()]
    lines += [f"f {a + 1}/{t} {b + 1}/{t + 1} {c + 1}/{t + 2}\n"
              for t, (a, b, c) in zip(range(1, 3 * len(f_np), 3),
                                      f_np.tolist())]
    _write_lines(base + ".obj", lines)
    return verts, faces, tex
