"""The grid encode and the NGP field over a scene axis: the port of
``jax.vmap`` over them in the JAX package's scene-batched loop.

* The plain encode of (S, N, 3) points with (S, T, C) tables equals S
  single-scene encodes, the forward exactly (the same rows and weights),
  the table gradient to 1e-6 (``embedding_bag``'s scatter over the one
  (S T, C) table sums a row's terms in another order), for tiled and
  hash grids and f32 and bf16 tables; and
  equals ``jax.vmap`` of the JAX ``grid_encode`` to the f32 tolerances
  of ``test_torch_grid_encode`` (atol 1e-5 values, 1e-4 gradients).
* ``NGPFieldStack`` against its fields: the same density and albedo
  (exact for the sigma net; 1e-6 for the background net, whose batched
  matmul sums in another order), ``field_at`` gives the fields back, and
  ``from_jax_params`` reads the JAX batched loop's stacked params.
* The kernel wrappers' checks of scene-batched shapes (the kernels
  themselves run in ``test_torch_kernels_cuda`` on the card).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.nn.ngp import NGPConfig as JNGPConfig
from sparsefusion_tpu.nn.ngp import NGPField as JNGPField
from sparsefusion_tpu.ops.grid_encode import grid_encode as jax_grid_encode
from sparsefusion_tpu.ops.grid_encode import (
    make_grid_encoding as jax_make_grid_encoding,
)
from sparsefusion_tpu_torch.kernels import grid_encode as kernels
from sparsefusion_tpu_torch.nn.ngp import (
    NGPConfig,
    NGPField,
    NGPFieldStack,
    export_jax_params,
)
from sparsefusion_tpu_torch.ops.grid_encode import (
    grid_encode,
    grid_encode_bound,
    grid_encode_plain,
    make_grid_encoding,
)
from tests.test_torch_grid_encode import ENC_KW

torch.set_num_threads(2)

S, N = 3, 80


def _scene_inputs(enc, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.rand(S, N, 3) * 1.1 - 0.05).astype(np.float32)
    tables = (rng.randn(S, enc.total_params, enc.level_dim) * 0.5
              ).astype(np.float32)
    g = rng.randn(S, N, enc.output_dim).astype(np.float32)
    return x, tables, g


@pytest.mark.parametrize("gridtype,table_dtype", [
    ("tiled", None), ("hash", None), ("tiled", "bfloat16")])
def test_scene_encode_equals_single_encodes(gridtype, table_dtype):
    enc = make_grid_encoding(**ENC_KW[gridtype])
    x, tables, g = _scene_inputs(enc)
    t = torch.tensor(tables, requires_grad=True)
    out = grid_encode(torch.tensor(x), t, enc, table_dtype)
    (out * torch.tensor(g)).sum().backward()
    assert out.shape == (S, N, enc.output_dim)
    for s in range(S):
        ts = torch.tensor(tables[s], requires_grad=True)
        want = grid_encode_plain(torch.tensor(x[s]), ts, enc, table_dtype)
        (want * torch.tensor(g[s])).sum().backward()
        assert torch.equal(out[s], want), s
        torch.testing.assert_close(t.grad[s], ts.grad, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_scene_encode_matches_jax_vmap(gridtype):
    enc = make_grid_encoding(**ENC_KW[gridtype])
    jenc = jax_make_grid_encoding(**ENC_KW[gridtype])
    x, tables, g = _scene_inputs(enc, seed=1)

    def loss(t):
        out = jax.vmap(lambda xs, ts: jax_grid_encode(xs, ts, jenc))(
            jnp.asarray(x), t)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jnp.asarray(tables))
    t = torch.tensor(tables, requires_grad=True)
    out = grid_encode_plain(torch.tensor(x), t, enc)
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g), atol=1e-4)


def test_scene_encode_bound_keeps_the_scene_axis():
    enc = make_grid_encoding(**ENC_KW["tiled"])
    x, tables, _ = _scene_inputs(enc)
    xw = torch.tensor(x).reshape(S, 8, 10, 3) * 8.0 - 4.0
    out = grid_encode_bound(xw, torch.tensor(tables), enc, bound=4.0)
    assert out.shape == (S, 8, 10, enc.output_dim)
    for s in range(S):
        want = grid_encode_bound(xw[s], torch.tensor(tables[s]), enc,
                                 bound=4.0)
        assert torch.equal(out[s], want)


NGP_KW = dict(num_levels=4, log2_hashmap_size=10, bg_radius=1.0)


def test_field_stack_equals_its_fields():
    g = torch.Generator().manual_seed(0)
    fields = [NGPField(NGPConfig(**NGP_KW), generator=g) for _ in range(S)]
    stack = NGPFieldStack(fields)
    x = torch.rand(S, 7, 5, 3, generator=g) * 8.0 - 4.0
    sigma, albedo = stack(x)
    bg = stack.background(torch.nn.functional.normalize(x, dim=-1))
    assert sigma.shape == (S, 7, 5) and albedo.shape == (S, 7, 5, 3)
    for s, f in enumerate(fields):
        want_sigma, want_albedo = f(x[s])
        assert torch.equal(sigma[s], want_sigma)
        assert torch.equal(albedo[s], want_albedo)
        torch.testing.assert_close(
            bg[s], f.background(torch.nn.functional.normalize(x[s], dim=-1)),
            rtol=1e-6, atol=1e-6)
        back = stack.field_at(s)
        for (n, a), b in zip(f.named_parameters(), back.parameters()):
            assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="one NGPConfig"):
        NGPFieldStack([fields[0], NGPField(NGPConfig(num_levels=2,
                                                     log2_hashmap_size=10))])


def test_field_stack_reads_the_jax_batched_params():
    """The JAX batched loop's params: one vmapped init, every leaf with a
    leading S axis."""
    model = JNGPField(JNGPConfig(num_levels=4, log2_hashmap_size=10))
    params = jax.jit(jax.vmap(
        lambda k: model.init(k, jnp.zeros((8, 3)))["params"]))(
            jax.random.split(jax.random.PRNGKey(0), S))
    params = jax.tree_util.tree_map(np.asarray, params)
    stack = NGPFieldStack.from_jax_params(
        NGPConfig(num_levels=4, log2_hashmap_size=10), params)
    assert stack.grid.shape == (S,) + params["grid"].shape[1:]
    for s in range(S):
        mine = export_jax_params(stack.field_at(s))
        np.testing.assert_array_equal(mine["grid"], params["grid"][s])
        for name in ("sigma_net_0", "sigma_net_1", "sigma_net_2"):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(mine[name][leaf],
                                              params[name][leaf][s])


def test_kernel_wrappers_check_scene_shapes():
    enc = make_grid_encoding(**ENC_KW["tiled"])
    x, tables, _ = _scene_inputs(enc)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.grid_encode_cuda(torch.tensor(x), torch.tensor(tables), enc)
    kernels._check_table(torch.tensor(tables), enc, (S,) + tables.shape[1:])
    with pytest.raises(ValueError, match="table shape"):
        kernels._check_table(torch.tensor(tables[:2]), enc,
                             (S,) + tables.shape[1:])
    with pytest.raises(ValueError, match="table shape"):
        kernels._check_table(torch.tensor(tables), enc)
    assert kernels._table_shape(torch.tensor(x), enc) == tables.shape


@pytest.mark.parametrize("points", [80, 262, 1024])
def test_stacked_dense_gradient_equals_autograd_of_baddbmm(points):
    """The stacked layers' kernel gradient, split along the points (16,
    2 and 64 pieces here), equals autograd's through one ``baddbmm`` to
    f32 rounding: a sum of ``points`` unit-size products in another
    order, so within ``points`` x 1e-6."""
    from sparsefusion_tpu_torch.nn.ngp import StackedDense

    g = torch.Generator().manual_seed(points)
    h = torch.randn(S, points, 32, generator=g)
    layer = StackedDense(torch.randn(S, 32, 16, generator=g),
                         torch.randn(S, 16, generator=g))
    up = torch.randn(S, points, 16, generator=g)
    x = h.clone().requires_grad_()
    (layer(x) * up).sum().backward()
    k = layer.kernel.detach().clone().requires_grad_()
    b = layer.bias.detach().clone().requires_grad_()
    x0 = h.clone().requires_grad_()
    (torch.baddbmm(b[:, None, :], x0, k) * up).sum().backward()
    torch.testing.assert_close(layer.kernel.grad, k.grad, rtol=0,
                               atol=points * 1e-6)
    torch.testing.assert_close(layer.bias.grad, b.grad)
    torch.testing.assert_close(x.grad, x0.grad)
