"""Row gather: ``out[i] = table[idx[i]]`` for rows of a 2-D table.

Counterpart of the VMEM row gather of
``benchmarks/pallas_gather_micro.py::make_vmem_gather``: a (R, 128)
table, bf16 there (the function takes the dtype as a parameter), held
whole in fast memory, and a vector of row indices.  The TPU kernel needs
the indices broadcast to the table's (rows, 128) shape; that was a limit
of its lowering, not part of the function, so here they are an (N,)
int32 vector.

:func:`row_gather` dispatches on the device of its input: a CUDA tensor
goes to the hand-written kernel (``kernels/row_gather.py``), a CPU tensor
to :func:`row_gather_plain`, the plain PyTorch version below.
"""
from __future__ import annotations

import torch


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, W) table, (N,) int32 or int64 indices in [0, R) -> (N, W) rows:
    one ``index_select``, which takes int32 indices as they are."""
    return table.index_select(0, idx)


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows of ``table``.  A CUDA tensor always goes to the kernel,
    which writes a row of zeros for an index outside [0, R); a CPU tensor
    to the plain version."""
    if table.is_cuda:
        from sparsefusion_tpu_torch.kernels.row_gather import row_gather_cuda

        return row_gather_cuda(table, idx)
    return row_gather_plain(table, idx)
