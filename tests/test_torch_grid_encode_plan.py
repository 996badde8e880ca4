"""The grid-encode kernels' host side, on the CPU.

``kernels/grid_encode.py::level_plan`` mirrors ``make_levels`` in
``csrc/grid_encode.cu``: how each level's uint32 corner index is reduced
to the level's size (identity, a mask, or a modulo).  Each reduction must
equal ``index % size`` on every index the level can produce, which is
checked here on the extreme corners of the unit box, on seeded random
points, and on random uint32 indices where a level wraps.  The level
tables are the JAX package's (``make_grid_encoding`` and ``NGPConfig``
agree field by field).  The card test holds the C plan to this mirror.
"""
import dataclasses

import numpy as np
import pytest
import torch

from sparsefusion_tpu.nn.ngp import NGPConfig as JaxNGPConfig
from sparsefusion_tpu.ops.grid_encode import (
    make_grid_encoding as jax_make_grid_encoding,
)
from sparsefusion_tpu_torch.kernels import grid_encode as kernels
from sparsefusion_tpu_torch.nn.ngp import NGPConfig
from sparsefusion_tpu_torch.ops.grid_encode import (
    grid_corner_index,
    make_grid_encoding,
)

torch.set_num_threads(2)

# name -> (the port's encoding, the JAX package's)
CONFIGS = {
    "ngp_16xC2": lambda: (NGPConfig().encoding(), JaxNGPConfig().encoding()),
    "ngp_8xC4": lambda: (NGPConfig(num_levels=8, level_dim=4).encoding(),
                         JaxNGPConfig(num_levels=8, level_dim=4).encoding()),
    **{f"hash_log2_{k}": lambda k=k: tuple(
        make(gridtype="hash", log2_hashmap_size=k)
        for make in (make_grid_encoding, jax_make_grid_encoding))
       for k in range(9, 20)},
}
FIELDS = ("offsets", "scales", "resolutions", "strides", "use_hash")


def _reduce(index, reduction, size):
    """uint32 indices reduced as the kernels do under ``reduction``."""
    if reduction == kernels.IDENTITY:
        return index
    if reduction == kernels.MASK:
        return index & np.uint64(size - 1)
    return index % np.uint64(size)


def _probe_points(seed):
    """The box's extreme corners (0, the float below 1, and 1 on each
    axis: the cells of the largest and smallest indices) and seeded
    random points in the box."""
    edge = np.array([0.0, np.nextafter(np.float32(1), np.float32(0)), 1.0],
                    np.float32)
    corners = np.stack(np.meshgrid(edge, edge, edge), -1).reshape(-1, 3)
    rng = np.random.RandomState(seed)
    return np.concatenate([corners, rng.rand(4096, 3).astype(np.float32)])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_level_table_matches_jax(name):
    port, jax_enc = CONFIGS[name]()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(jax_enc, f))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_takes_identity_or_mask(name):
    enc, _ = CONFIGS[name]()
    plan = kernels.level_plan(enc)
    assert len(plan) == enc.num_levels
    assert set(plan) <= {kernels.IDENTITY, kernels.MASK}, plan
    sizes = np.diff(enc.offsets)
    for lvl, r in enumerate(plan):
        if r == kernels.MASK:
            assert sizes[lvl] == 2 ** enc.log2_hashmap_size
    if name == "ngp_16xC2":
        # levels 0-2 (4,920 / 17,576 / 54,872 rows) cannot wrap; 3-15
        # wrap at 2^16
        assert plan == [kernels.IDENTITY] * 3 + [kernels.MASK] * 13


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_equals_modulo_on_corner_indices(name):
    enc, _ = CONFIGS[name]()
    index = grid_corner_index(torch.from_numpy(_probe_points(7)), enc)
    index = index.numpy().astype(np.uint64)                    # (B, L, 8)
    sizes = np.diff(enc.offsets)
    for lvl, r in enumerate(kernels.level_plan(enc)):
        idx = index[:, lvl].ravel()
        assert idx.max() < 2 ** 32
        np.testing.assert_array_equal(
            _reduce(idx, r, int(sizes[lvl])),
            idx % np.uint64(sizes[lvl]), err_msg=f"level {lvl} ({r})")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_equals_modulo_on_random_uint32(name):
    """Where a level wraps (hash levels, and tiled levels past their
    size), its index can be any uint32."""
    enc, _ = CONFIGS[name]()
    rng = np.random.RandomState(11)
    idx = rng.randint(0, 2 ** 32, size=1 << 14, dtype=np.uint64)
    idx[:2] = (0, 2 ** 32 - 1)
    sizes = np.diff(enc.offsets)
    wrapping = [(lvl, r) for lvl, r in enumerate(kernels.level_plan(enc))
                if r != kernels.IDENTITY]
    assert wrapping
    for lvl, r in wrapping:
        np.testing.assert_array_equal(
            _reduce(idx, r, int(sizes[lvl])),
            idx % np.uint64(sizes[lvl]), err_msg=f"level {lvl} ({r})")


def test_plan_takes_modulo_for_a_size_that_is_no_power_of_two():
    """No make_grid_encoding configuration has one, but the kernels take
    any level table: a wrapping level of 1000 rows gets the modulo."""
    enc = make_grid_encoding(num_levels=3, level_dim=2, base_resolution=16,
                             log2_hashmap_size=12, gridtype="hash")
    offsets = enc.offsets.copy()
    offsets[2:] += 1000 - (offsets[2] - offsets[1])
    odd = dataclasses.replace(enc, offsets=offsets)
    assert kernels.level_plan(odd)[1] == kernels.MODULO
    idx = np.random.RandomState(3).randint(0, 2 ** 32, 4096, dtype=np.uint64)
    np.testing.assert_array_equal(
        _reduce(idx, kernels.MODULO, 1000), idx % np.uint64(1000))


@pytest.mark.parametrize("level_dim,dtype,align", [
    (1, torch.float32, 4), (2, torch.float32, 8), (4, torch.float32, 16),
    (8, torch.float32, 16), (2, torch.bfloat16, 4), (4, torch.bfloat16, 8),
    (8, torch.bfloat16, 16)])
def test_table_check_wants_row_alignment(level_dim, dtype, align):
    """The kernels read each row with one vector load: the wrapper takes a
    table view only at an address aligned to min(row bytes, 16)."""
    enc = make_grid_encoding(num_levels=2, level_dim=level_dim,
                             log2_hashmap_size=9, gridtype="tiled")
    n = enc.total_params * level_dim
    flat = torch.zeros(n + 16, dtype=dtype)
    base = flat.data_ptr()
    for shift in range(16 // flat.element_size()):
        table = flat[shift:shift + n].view(enc.total_params, level_dim)
        if (base + shift * flat.element_size()) % align:
            with pytest.raises(ValueError, match="aligned"):
                kernels._check_table(table, enc)
        else:
            kernels._check_table(table, enc)
