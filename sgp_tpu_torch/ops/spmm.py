"""Sparse matrix × dense matrix products (the propagation operator).

Counterpart of ``sgp_tpu/ops/spmm.py``, with the same three representations
and the same ``build_operator`` thresholds:

- :class:`DenseOperator` — ``[N, N]`` on the device; ``A @ x`` is one
  ``torch.matmul`` in full f32 (the package turns TF32 off).
- :class:`BSROperator` — 128x128 block-sparse rows; ``A @ x`` is the CUDA
  kernel of ``ops/bsr_kernel.py`` on the card and its plain version on the
  CPU. The device decides; there is no ``variant`` argument.
- :class:`COOOperator` — gather + ``index_add_``.

Every operator takes ``x [..., N, F]`` and contracts over ``N``.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from sgp_tpu_torch.graph.sparse import Graph
from sgp_tpu_torch.ops.bsr_kernel import BLOCK, bsr_spmm, prepare_bsr


class DenseOperator:
    """Dense ``A[dst, src]``; propagation is one f32 matmul."""

    def __init__(self, mat: torch.Tensor):
        self.mat = mat

    @property
    def num_nodes(self) -> int:
        return self.mat.shape[0]

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.mat, x.to(self.mat.dtype)).to(x.dtype)

    def transpose(self) -> "DenseOperator":
        return DenseOperator(self.mat.T.contiguous())


class COOOperator:
    """COO gather/scatter-add: ``out[d] += w_e * x[s_e]``."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor,
                 weight: torch.Tensor, num_nodes: int):
        self.src = src
        self.dst = dst
        self.weight = weight
        self._num_nodes = int(num_nodes)

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        msgs = x.index_select(-2, self.src) * self.weight[:, None]
        out = msgs.new_zeros(x.shape[:-2] + (self._num_nodes, x.shape[-1]))
        return out.index_add_(-2, self.dst, msgs)

    def transpose(self) -> "COOOperator":
        return COOOperator(self.dst, self.src, self.weight, self._num_nodes)


class BSROperator:
    """128x128 block-sparse operator. ``[..., N, F]`` inputs are folded
    into one ``[N, prod(lead) * F]`` product, so a batch of streams is one
    kernel launch."""

    BLOCK = BLOCK

    def __init__(self, blocks, block_cols, row_ptr, block_rows,
                 num_nodes: int):
        self.blocks = blocks                # [nnzb, B, B] f32 or bf16
        self.block_cols = block_cols        # [nnzb] int32
        self.row_ptr = row_ptr              # [n_block_rows + 1] int32
        self.block_rows = block_rows        # [nnzb] int32 (sorted)
        self._num_nodes = int(num_nodes)

    @classmethod
    def from_bsr(cls, blocks, block_cols, row_ptr, num_nodes: int,
                 dtype=torch.float32, device=None) -> "BSROperator":
        b, cols, ptr, rows = prepare_bsr(blocks, block_cols, row_ptr)
        return cls(torch.as_tensor(b).to(device=device, dtype=dtype),
                   torch.as_tensor(cols, device=device),
                   torch.as_tensor(ptr, device=device),
                   torch.as_tensor(rows, device=device), num_nodes)

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        args = (self.blocks, self.block_cols, self.row_ptr, self.block_rows)
        if x.ndim == 2:
            return bsr_spmm(*args, x)
        lead, (n, f) = x.shape[:-2], x.shape[-2:]
        folded = x.reshape(-1, n, f).transpose(0, 1).reshape(n, -1)
        out = bsr_spmm(*args, folded)
        return out.reshape(n, -1, f).transpose(0, 1).reshape(lead + (n, f))


class GlobalMeanOperator:
    """The dense ``1/N`` matrix of the ``global_attr`` support, as an
    O(N·F) mean over nodes broadcast back."""

    def __init__(self, num_nodes: int):
        self._num_nodes = int(num_nodes)

    @property
    def num_nodes(self) -> int:
        return self._num_nodes

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(-2, keepdim=True).expand_as(x)

    def transpose(self) -> "GlobalMeanOperator":
        return self


Operator = Union[DenseOperator, COOOperator, BSROperator, GlobalMeanOperator]


def build_operator(g: Graph, mode: str = "auto", dtype=torch.float32,
                   precision: str = "highest", device=None) -> Operator:
    """Lift a host :class:`Graph` into a device propagation operator.

    ``auto``: dense up to a 512 MB ``[N, N]`` f32 operator, then BSR when
    under half the block positions are stored, COO otherwise.
    ``precision='default'`` stores BSR tiles in bf16 (accumulation stays
    f32), as in the JAX package; the dense operator always runs in f32.
    """
    if mode == "auto":
        dense_bytes = g.num_nodes * g.num_nodes * np.dtype(np.float32).itemsize
        if dense_bytes <= 512 * 1024 * 1024:  # <= 512 MB dense operator
            mode = "dense"
        else:
            blocks, cols, ptr = g.to_bsr(BSROperator.BLOCK)
            block_density = len(cols) / max(
                1, (ptr.shape[0] - 1) ** 2)
            mode = "bsr" if block_density < 0.5 else "coo"
    if mode == "dense":
        # scatter the edge list into [N, N] on the device; add matches
        # scipy's duplicate-sum semantics
        src = torch.as_tensor(g.src.astype(np.int64), device=device)
        dst = torch.as_tensor(g.dst.astype(np.int64), device=device)
        w = torch.as_tensor(g.weight, device=device).to(dtype)
        mat = torch.zeros((g.num_nodes, g.num_nodes), dtype=dtype,
                          device=device)
        mat.index_put_((dst, src), w, accumulate=True)
        return DenseOperator(mat)
    if mode == "bsr":
        blocks, cols, ptr = g.to_bsr(BSROperator.BLOCK)
        bsr_dtype = (torch.bfloat16 if precision == "default"
                     and dtype == torch.float32 else dtype)
        return BSROperator.from_bsr(blocks, cols, ptr, g.num_nodes,
                                    bsr_dtype, device)
    if mode == "coo":
        return COOOperator(
            torch.as_tensor(g.src.astype(np.int64), device=device),
            torch.as_tensor(g.dst.astype(np.int64), device=device),
            torch.as_tensor(g.weight, device=device).to(dtype), g.num_nodes)
    raise ValueError(f"unknown operator mode {mode!r}")

