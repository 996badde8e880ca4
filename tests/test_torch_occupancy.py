"""The port's occupancy grid (``render/occupancy.py``) against the JAX
package's, on the same inputs.

Morton codes, their inverse, the packed bitfield and the per-point lookup
are integer or comparison results: equal.  ``occupancy_near_far`` builds
its probes with ``linspace``, where torch and JAX differ by an ulp, so
near and far are held to 1e-6 relative and the hit flags equal.  The
density-grid update gets the JAX jitter, replayed along its key splits
(one split per cascade, then ``uniform(k, (H^3, 3))``), and the same
analytic density: the grid within 1e-6 relative of its largest value
(``exp`` differs by an ulp between the libraries) and the bitfield equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparsefusion_tpu.render import occupancy as J
from sparsefusion_tpu_torch.render import occupancy as T

torch.set_num_threads(2)

BOUND, GS = 4.0, 32
CASCADE = T.cascade_count(BOUND)

# the JAX functions under jit: eager, they compile op by op, which costs
# more than the comparisons themselves
_morton3D = jax.jit(J.morton3D)
_morton3D_invert = jax.jit(J.morton3D_invert)
_density_grid_update = jax.jit(J.density_grid_update,
                               static_argnums=(1, 3, 4, 5, 6, 7))
_occupancy_lookup = jax.jit(J.occupancy_lookup, static_argnums=(2, 3, 4))
_occupancy_near_far = jax.jit(J.occupancy_near_far,
                              static_argnums=(5, 6, 7, 8))


def _ball_j(p):
    return 20.0 * jnp.exp(-jnp.sum(p ** 2, axis=-1) / (2 * 0.6 ** 2))


def _ball_t(p):
    return 20.0 * torch.exp(-(p ** 2).sum(dim=-1) / (2 * 0.6 ** 2))


def _replayed_jitter(key, cascade, gs):
    """The uniforms JAX ``density_grid_update`` draws from ``key``."""
    out = []
    for _ in range(cascade):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(k, (gs ** 3, 3))))
    return torch.tensor(np.stack(out))


@functools.lru_cache(maxsize=None)
def _updated_grids(decay=0.95):
    """Two updates from an empty grid on both sides: (JAX grid, bitfield,
    mean), (port grid, bitfield, mean)."""
    grid_j = jnp.zeros((CASCADE, GS ** 3), jnp.float32)
    grid_t = torch.zeros(CASCADE, GS ** 3)
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        grid_j, bf_j, mean_j = _density_grid_update(
            grid_j, _ball_j, key, BOUND, GS, CASCADE, 10.0, decay)
        grid_t, bf_t, mean_t = T.density_grid_update(
            grid_t, _ball_t, BOUND, GS, CASCADE, 10.0, decay,
            jitter=_replayed_jitter(key, CASCADE, GS))
    return (grid_j, bf_j, mean_j), (grid_t, bf_t, mean_t)


def test_morton_codes_and_inverse_match_jax():
    rng = np.random.RandomState(0)
    coords = rng.randint(0, 1024, (4096, 3)).astype(np.int32)
    full = np.stack(np.meshgrid(*[np.arange(32)] * 3, indexing="ij"),
                    -1).reshape(-1, 3).astype(np.int32)
    for c in (coords, full):
        want = np.asarray(_morton3D(jnp.asarray(c)))
        got = T.morton3D(torch.tensor(c))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        back = T.morton3D_invert(got)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(_morton3D_invert(jnp.asarray(want))))
        np.testing.assert_array_equal(back.numpy(), c)
    # neighbours of the origin, as the JAX test has them
    np.testing.assert_array_equal(
        T.morton3D(torch.tensor([[0, 0, 0], [1, 0, 0], [0, 1, 0],
                                 [0, 0, 1]])).numpy(), [0, 1, 2, 4])


def test_packbits_matches_jax():
    rng = np.random.RandomState(1)
    grid = rng.rand(CASCADE, 4096).astype(np.float32)
    np.testing.assert_array_equal(
        T.packbits(torch.tensor(grid), 0.37).numpy(),
        np.asarray(J.packbits(jnp.asarray(grid), 0.37)))
    # cell 8j + k in bit k of byte j, least significant first
    one = torch.zeros(1, 16)
    one[0, 3] = one[0, 9] = 5.0
    assert T.packbits(one, 1.0).tolist() == [1 << 3, 1 << 1]


def test_density_grid_update_matches_jax():
    (grid_j, bf_j, mean_j), (grid_t, bf_t, mean_t) = _updated_grids()
    grid_j = np.asarray(grid_j)
    assert np.abs(grid_t.numpy() - grid_j).max() <= 1e-6 * grid_j.max()
    assert float(mean_t) == pytest.approx(float(mean_j), rel=1e-6)
    np.testing.assert_array_equal(bf_t.numpy(), np.asarray(bf_j))
    bits = np.unpackbits(bf_t.numpy())
    assert 0 < bits.sum() < bits.size        # neither empty nor full


def test_occupancy_grid_state_matches_jax():
    """The stateful wrapper: one update, then queries."""
    g_j = J.OccupancyGrid(bound=BOUND, grid_size=GS, density_thresh=0.5)
    g_t = T.OccupancyGrid(bound=BOUND, grid_size=GS, density_thresh=0.5)
    assert g_t.cascade == g_j.cascade == CASCADE
    assert torch.equal(g_t.full_bitfield(),
                       torch.full((CASCADE * GS ** 3 // 8,), 255,
                                  dtype=torch.uint8))
    key = jax.random.PRNGKey(0)
    g_j.update(_ball_j, key)
    g_t.update(_ball_t, jitter=_replayed_jitter(key, CASCADE, GS))
    assert g_t.iter_density == 1
    assert g_t.mean_density == pytest.approx(g_j.mean_density, rel=1e-6)
    np.testing.assert_array_equal(g_t.bitfield.numpy(),
                                  np.asarray(g_j.bitfield))
    assert bool(g_t.occupancy_at(torch.zeros(1, 3))[0])
    assert not bool(g_t.occupancy_at(torch.tensor([[3.5, 3.5, 3.5]]))[0])


def test_occupancy_lookup_matches_jax_in_every_cascade():
    (_, bf_j, _), (_, bf_t, _) = _updated_grids()
    rng = np.random.RandomState(2)
    # points in each cascade's shell and beyond the box
    x = np.concatenate([rng.uniform(-s, s, (3000, 3))
                        for s in (0.9, 1.9, 3.9, 6.0)]).astype(np.float32)
    want = np.asarray(_occupancy_lookup(bf_j, jnp.asarray(x), BOUND, GS,
                                        CASCADE))
    got = T.occupancy_lookup(bf_t, torch.tensor(x), BOUND, GS, CASCADE)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_occupancy_near_far_matches_jax():
    (_, bf_j, _), (_, bf_t, _) = _updated_grids()
    rng = np.random.RandomState(3)
    n = 2048
    o = (rng.randn(n, 3) * 3).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=1, keepdims=True) \
        + 0.2 * rng.randn(n, 3).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    near = (rng.rand(n) * 2 + 0.1).astype(np.float32)
    far = (near + rng.rand(n) * 6).astype(np.float32)
    # a ray that misses the box: near = far = 1e10, as the renderer gives
    near[0] = far[0] = 1e10
    nj, fj, aj = _occupancy_near_far(bf_j, *map(jnp.asarray, (o, d, near,
                                                              far)),
                                     BOUND, GS, CASCADE, 64)
    nt, ft, at = T.occupancy_near_far(bf_t, *map(torch.tensor, (o, d, near,
                                                                far)),
                                      BOUND, GS, CASCADE, 64)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-6)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6)
    assert 0 < at.sum() < n
    tightened = (nt.numpy() > near) | (ft.numpy() < far)
    assert tightened.sum() > n // 4
