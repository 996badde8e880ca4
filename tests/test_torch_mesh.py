"""Port mesh export (``render/mesh.py``) vs the JAX package's, on the CPU.

Tolerances: marching tetrahedra runs the same arithmetic on the same
grid in both packages, so faces are equal and vertices agree to 1e-6;
an NGP field's density differs by float32 rounding between the two
libraries, so its exported files are compared parsed: faces equal,
vertices to 1e-5 (measured 4.3e-7), the albedo at the same points to
1e-6, and the vertex colours written to 1e-4, because the field's finest
level (2048 cells a unit) moves the albedo ~50x as far as the vertex
moved; the baked atlas to 1e-5, its PNG pixels equal.
"""
import re

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.nn.ngp import NGPConfig as JNGPConfig
from sparsefusion_tpu.nn.ngp import NGPField as JNGPField
from sparsefusion_tpu.render import mesh as jmesh
from sparsefusion_tpu_torch.nn.ngp import NGPConfig, NGPField, load_jax_params
from sparsefusion_tpu_torch.render import mesh as tmesh

torch.set_num_threads(2)


def _sphere_grid():
    n = 32
    xs = np.linspace(-1, 1, n)
    g = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"), axis=-1)
    return (1.0 - np.linalg.norm(g, axis=-1), 0.5,
            np.array([-1.0, -1.0, -1.0]), np.full(3, xs[1] - xs[0]))


def _random_grid():
    rng = np.random.RandomState(0)
    values = rng.rand(24, 24, 24).astype(np.float32)
    return values, 0.5, np.array([-2.0, -1.0, 0.5]), np.full(3, 0.125)


@pytest.mark.parametrize("make", [_sphere_grid, _random_grid],
                         ids=["sphere", "random24"])
def test_marching_tetrahedra_matches_jax(make):
    values, iso, origin, spacing = make()
    jv, jf = jmesh.marching_tetrahedra(values, iso, origin, spacing)
    tv, tf = tmesh.marching_tetrahedra(torch.from_numpy(values), iso,
                                       origin, spacing)
    assert len(jf) > 100
    assert tv.dtype == torch.float32 and tf.dtype == torch.int32
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-6)


def test_unique_rows_matches_numpy():
    """The vertex dedupe: ``np.unique(axis=0)``'s order, first indices and
    inverse, on keys with many repeats and negative entries."""
    rng = np.random.RandomState(3)
    for n, hi in ((1, 2), (500, 3), (100000, 40)):
        key = rng.randint(-hi, hi, (n, 3)).astype(np.int64)
        _, first, inv = np.unique(key, axis=0, return_index=True,
                                  return_inverse=True)
        tfirst, tinv = tmesh._unique_rows(torch.from_numpy(key))
        np.testing.assert_array_equal(tfirst.numpy(), first)
        np.testing.assert_array_equal(tinv.numpy(), inv.reshape(-1))


def test_marching_tetrahedra_empty():
    v, f = tmesh.marching_tetrahedra(torch.zeros(4, 4, 4), 1.0,
                                     np.zeros(3), np.ones(3))
    assert v.shape == (0, 3) and f.shape == (0, 3)


def _ngp_fields(seed=0):
    """A narrow NGP field over [-1, 1]^3 in both packages, one weight set
    (the table well away from its 1e-4 init, so the surface is bumpy)."""
    kw = dict(bound=1.0, num_levels=4, log2_hashmap_size=12)
    model = JNGPField(JNGPConfig(**kw))
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((8, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    rng = np.random.RandomState(seed)
    params["grid"] = (rng.randn(*params["grid"].shape) * 0.5
                      ).astype(np.float32)
    field = NGPField(NGPConfig(**kw))
    load_jax_params(field, params)

    def japply(x):
        return model.apply({"params": params}, x, method=JNGPField.density)

    return japply, field


def _parse_obj(text):
    v = np.array([ln.split()[1:] for ln in text.splitlines()
                  if ln.startswith("v ")], np.float64)
    vt = np.array([ln.split()[1:] for ln in text.splitlines()
                   if ln.startswith("vt ")], np.float64)
    f = [ln.split()[1:] for ln in text.splitlines() if ln.startswith("f ")]
    return v, vt, f


def test_export_mesh_ngp_field_matches_jax(tmp_path):
    japply, field = _ngp_fields()
    jpath, tpath = tmp_path / "j.obj", tmp_path / "t.obj"
    kw = dict(bound=1.0, resolution=24)
    jv, jf = jmesh.export_mesh(lambda x: japply(x)["sigma"], str(jpath),
                               color_fn=lambda x: japply(x)["albedo"], **kw)
    tv, tf = tmesh.export_mesh(lambda x: field.density(x)["sigma"],
                               str(tpath),
                               color_fn=lambda x: field.density(x)["albedo"],
                               device="cpu", **kw)
    assert len(jf) > 100
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-5)
    jtext, ttext = jpath.read_text(), tpath.read_text()
    jpv, _, jpf = _parse_obj(jtext)
    tpv, _, tpf = _parse_obj(ttext)
    assert jpf == tpf and len(jpf) == len(jf)
    # x y z r g b on every vertex line
    assert jpv.shape == tpv.shape == (len(jv), 6)
    np.testing.assert_allclose(tpv[:, :3], jpv[:, :3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tpv[:, 3:], jpv[:, 3:], rtol=0, atol=1e-4)
    same = field.density(torch.from_numpy(jv))["albedo"].detach().numpy()
    np.testing.assert_allclose(same, np.asarray(japply(jv)["albedo"]),
                               rtol=0, atol=1e-6)


def test_export_mesh_grid_is_numpy_linspace():
    """The grid's points are numpy's float32 linspace, bit for bit."""
    seen = []

    def field(x):
        seen.append(x.clone())
        return torch.zeros(len(x))

    values = tmesh.density_grid(field, bound=4.0, resolution=37, chunk=4096,
                                device="cpu")
    assert values.shape == (37, 37, 37)
    xs = np.linspace(-4.0, 4.0, 37, dtype=np.float32)
    want = np.stack(np.meshgrid(xs, xs, xs, indexing="ij"),
                    axis=-1).reshape(-1, 3)
    np.testing.assert_array_equal(torch.cat(seen).numpy(), want)
    assert [len(s) for s in seen] == [4096] * 12 + [37 ** 3 - 4096 * 12]


def _sphere_fields():
    def jfield(x):
        return 20.0 * (0.6 - jnp.linalg.norm(x, axis=-1))

    def jcolor(x):
        return jnp.clip(x * 0.5 + 0.5, 0.0, 1.0)

    def tfield(x):
        return 20.0 * (0.6 - torch.linalg.norm(x, dim=-1))

    def tcolor(x):
        return torch.clamp(x * 0.5 + 0.5, 0.0, 1.0)

    return jfield, jcolor, tfield, tcolor


def _textured_pair(tmp_path, jfield, jcolor, tfield, tcolor, **kw):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jout = jmesh.export_mesh_textured(
        jfield, jcolor, str(tmp_path / "j" / "tex.obj"), **kw)
    tout = tmesh.export_mesh_textured(
        tfield, tcolor, str(tmp_path / "t" / "tex.obj"), device="cpu", **kw)
    files = {}
    for side in "jt":
        files[side] = {
            "png": imageio.imread(tmp_path / side / "tex.png"),
            "mtl": (tmp_path / side / "tex.mtl").read_text(),
            "obj": (tmp_path / side / "tex.obj").read_text()}
    return jout, tout, files["j"], files["t"]


def _check_textured_files(jf, jfiles, tfiles, vert_tol):
    assert tfiles["png"].dtype == np.uint8
    assert tfiles["png"].shape == jfiles["png"].shape
    assert tfiles["mtl"] == jfiles["mtl"]
    jtext, ttext = jfiles["obj"], tfiles["obj"]
    assert ttext.splitlines()[:2] == ["mtllib tex.mtl", "usemtl tex"]
    jpv, jvt, jpf = _parse_obj(jtext)
    tpv, tvt, tpf = _parse_obj(ttext)
    assert tpf == jpf and len(tvt) == 3 * len(jf)
    np.testing.assert_allclose(tpv, jpv, rtol=0, atol=vert_tol)
    # the vt lines print the same float64 uvs
    assert re.findall(r"\nvt .*", ttext) == re.findall(r"\nvt .*", jtext)


def test_export_mesh_textured_matches_jax(tmp_path):
    """The analytic sphere and linear albedo of ``tests/test_mesh.py``."""
    (jv, jf, jtex), (tv, tf, ttex), jfiles, tfiles = _textured_pair(
        tmp_path, *_sphere_fields(), bound=1.0, resolution=20,
        density_thresh=2.0, block=4)
    assert len(jf) > 50
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_allclose(ttex.numpy(), jtex, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tfiles["png"], jfiles["png"])
    _check_textured_files(jf, jfiles, tfiles, 1e-6)


def test_export_mesh_textured_ngp_field_matches_jax(tmp_path):
    """An NGP field: the bake on the same vertices agrees to 1e-5 (PNG
    equal); end to end the vertices differ by float32 rounding of the
    density, which the fine levels amplify in the albedo (see the module
    docstring), so there the atlas agrees to 1e-4 and the PNG to one
    level."""
    japply, field = _ngp_fields(seed=1)
    (jv, jf, jtex), (tv, tf, ttex), jfiles, tfiles = _textured_pair(
        tmp_path, lambda x: japply(x)["sigma"],
        lambda x: japply(x)["albedo"], lambda x: field.density(x)["sigma"],
        lambda x: field.density(x)["albedo"], bound=1.0, resolution=24)
    assert len(jf) > 50
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_allclose(ttex.numpy(), jtex, rtol=0, atol=1e-4)
    diff = np.abs(tfiles["png"].astype(int) - jfiles["png"].astype(int))
    assert diff.max() <= 1
    _check_textured_files(jf, jfiles, tfiles, 1e-5)

    jtex2, juvs = jmesh.bake_texture(
        jv, jf, lambda p: japply(jnp.asarray(p, jnp.float32))["albedo"])
    ttex2, tuvs = tmesh.bake_texture(
        torch.from_numpy(jv), torch.from_numpy(jf),
        lambda p: field.density(p)["albedo"])
    np.testing.assert_array_equal(tuvs, juvs)
    np.testing.assert_allclose(ttex2.numpy(), jtex2, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        (ttex2.flip(0) * 255).to(torch.uint8).numpy(),
        (jtex2[::-1] * 255).astype(np.uint8))


def test_export_mesh_textured_no_faces(tmp_path):
    v, f, tex = tmesh.export_mesh_textured(
        lambda x: torch.zeros(len(x)), lambda x: torch.zeros(len(x), 3),
        str(tmp_path / "empty.obj"), bound=1.0, resolution=8, device="cpu")
    assert len(f) == 0 and tex is None
    assert (tmp_path / "empty.obj").exists()
    assert not (tmp_path / "empty.png").exists()


def test_bake_blends_the_two_faces_of_a_cell_in_both_packages():
    """The reference behaviour the port keeps: faces 2c and 2c + 1 share
    chart cell c, each is written over the whole cell, and every texel of
    the cell holds the mean of the two faces' colours, though the two
    faces are neighbours in face order only."""
    verts = np.array([[0, 0, 0], [0.1, 0, 0], [0, 0.1, 0],
                      [5, 0, 0], [5.1, 0, 0], [5, 0.1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)

    def jcolor(p):
        c = np.where(np.asarray(p)[:, :1] < 1.0, 0.05, 1.0)
        return np.repeat(c, 3, axis=1).astype(np.float32)

    def tcolor(p):
        return torch.where(p[:, :1] < 1.0, 0.05, 1.0).expand(-1, 3).float()

    block = 4
    jtex, juvs = jmesh.bake_texture(verts, faces, jcolor, block=block)
    ttex, tuvs = tmesh.bake_texture(torch.from_numpy(verts),
                                    torch.from_numpy(faces), tcolor,
                                    block=block)
    np.testing.assert_array_equal(tuvs, juvs)
    np.testing.assert_array_equal(ttex.numpy(), jtex)
    cell = ttex[:block, :block].numpy()
    mean = (np.float32(0.05) + np.float32(1.0)) / 2
    np.testing.assert_allclose(cell, mean, rtol=0, atol=1e-7)
    assert (ttex[block:] == 0).all() and (ttex[:, block:] == 0).all()


def test_write_png_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (7, 5, 3)).astype(np.uint8)
    tmesh.write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(imageio.imread(tmp_path / "a.png"), img)
