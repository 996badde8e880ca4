"""The row gather (K3) against the JAX micro-benchmark's Pallas kernel.

``benchmarks/pallas_gather_micro.py::make_vmem_gather`` runs here in
Pallas interpret mode: its module's ``pl`` is swapped, for the test
only, for a namespace whose ``pallas_call`` interprets; the file itself
is untouched.  Its indices go in broadcast to (rows, 128), as the Mosaic
lowering needs; the port's go in as an (N,) vector.  A gather is exact,
so the port's plain version (what ``row_gather`` runs on the CPU) must
be bit-equal.  The kernel itself is held against the plain version on
the card (``test_torch_kernels_cuda.py``).
"""
import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from sparsefusion_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from sparsefusion_tpu_torch.tools import gather_micro

torch.set_num_threads(2)


@pytest.fixture
def micro(monkeypatch):
    import benchmarks.pallas_gather_micro as micro_mod

    monkeypatch.setattr(micro_mod, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    return micro_mod


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("table_rows", [256, 512])
def test_row_gather_matches_the_pallas_micro(micro, table_rows, dtype):
    n_chunks = 3
    rng = np.random.RandomState(table_rows)
    table32 = rng.randn(table_rows, 128).astype(np.float32)
    idx = rng.randint(0, table_rows, n_chunks * table_rows).astype(np.int32)
    jdtype = getattr(jnp, dtype)
    table_j = jnp.asarray(table32).astype(jdtype)
    idx_b = jnp.broadcast_to(jnp.asarray(idx)[:, None],
                             (n_chunks * table_rows, 128))
    want = micro.make_vmem_gather(table_rows, n_chunks, jdtype)(table_j,
                                                                idx_b)
    assert want.shape == (n_chunks * table_rows, 128) and want.dtype == jdtype
    np.testing.assert_array_equal(np.asarray(want),
                                  np.asarray(jnp.take(table_j, idx, axis=0)))

    table_t = torch.tensor(table32).to(getattr(torch, dtype))
    got = row_gather(table_t, torch.tensor(idx))
    assert got.dtype == table_t.dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # int64 indices give the same rows
    assert torch.equal(row_gather_plain(table_t, torch.tensor(idx).long()),
                       got)


def test_gather_micro_cpu_runs_the_plain_version(capsys):
    results = gather_micro.main(["4096", "--device", "cpu"])
    assert sorted(results) == list(gather_micro.TABLE_ROWS)
    for r, res in results.items():
        # the JAX micro's row count: max(1, N // R) chunks of R
        assert res["rows"] == max(1, 4096 // r) * r
        assert res["correct"] and res["dtype"] == "bfloat16"
        assert res["host_ms_cpu"] > 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("R=")]
    assert len(lines) == 3 and all("correct=True" in ln for ln in lines)


def test_gather_micro_inputs_and_bound():
    table, idx = gather_micro.make_inputs(8192, 131072)
    assert table.shape == (8192, 128) and table.dtype == torch.bfloat16
    assert idx.shape == (131072,) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 8192
    # 131072 x (4 + 256) bytes + the 2 MiB table at 3.35 TB/s
    assert gather_micro.bound_ms(131072, table) == pytest.approx(
        (131072 * 260 + 8192 * 256) / 3.35e12 * 1e3)
    again, _ = gather_micro.make_inputs(8192, 131072)
    assert torch.equal(table, again)


def test_gather_micro_refuses_cuda_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gather_micro.run(1024, "cuda")
