"""Boundary halo exchange for node-sharded K-hop propagation.

Counterpart of ``sgp_tpu/parallel/halo.py``. The node dimension is cut
into ``S`` contiguous blocks of ``Nl`` rows, one per rank of a mesh axis;
each hop exchanges only the boundary rows that a shard's in-edges read
from the other shards (``all_to_all`` on the axis's process group), not
the whole ``[N, F]`` activation:

    out_local = A_local @ x_local + A_halo @ all_to_all(x_local[send_idx])

The plan is built on the host (:func:`build_halo_spec`) with every array
stacked per shard, as the JAX package builds it; each rank moves only its
own slice to its device (:meth:`HaloSpec.shard`). The diagonal block comes
in three forms:

- ``dense``: ``[Nl, Nl]``, one ``torch.matmul`` (the JAX package's einsum,
  which runs outside any Pallas kernel);
- ``bsr``: 128x128 tiles at the stored block positions with f32 sums per
  block row, which is K1's function: a rank runs its tiles through
  ``ops/bsr_kernel.py::bsr_spmm`` (the op ``sgp::bsr_spmm``: the CUDA
  kernel on the card, its plain version on the CPU), the leading dims
  folded into the columns. The JAX package computes it with an einsum and
  a ``segment_sum``;
- ``coo``: gather and ``index_add_``.

The off-diagonal (halo) entries are a dense ``[Nl, S*B]`` block in
``dense`` mode and COO otherwise. Unlike JAX's global sharded array, a
rank holds only its slab ``[..., Nl, F]``: :func:`shard_nodes` cuts it
from the whole array (applying the plan's node permutation, where the
whole array exists) and :func:`gather_nodes` assembles and un-permutes a
node-sharded result. The two-level (host, chip) plan is not ported yet
(ROADMAP A10, item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from sgp_tpu_torch.graph.sparse import Graph, permute_nodes, rcm_order
from sgp_tpu_torch.ops.bsr_kernel import bsr_spmm
from sgp_tpu_torch.parallel import collectives
from sgp_tpu_torch.parallel.mesh import Mesh

_BLOCK = 128
_PAYLOADS = {"float32": 4, "bfloat16": 2, "int8": 1}


def _hier_unported():
    return NotImplementedError(
        "the two-level (host, chip) halo exchange is not ported yet "
        "(ROADMAP A10, item 5)")


@dataclasses.dataclass
class HaloSpec:
    """Host-built halo-exchange plan for a 1-D node partition, every array
    stacked per shard (leading dim ``S``) in numpy.

    - ``local``: the diagonal block of each shard's rows of ``A``: dense
      ``(a_local [S, Nl, Nl],)``; bsr ``(blocks [S, nb, 128, 128], brows
      [S, nb], bcols [S, nb])`` with each shard's tiles first and zero
      tiles at ``(0, 0)`` after them up to the largest shard's count
      (``bsr_tiles [S]`` counts the real ones); coo ``(src, dst, w)``
      ``[S, E]`` with zero-weight padding.
    - ``halo``: the off-diagonal entries, columns in the recv layout (peer
      ``j``'s section ``j*B:(j+1)*B``): dense ``(a_halo [S, Nl, S*B],)``,
      else COO ``(hsrc, hdst, hw)`` ``[S, Eh]``.
    - ``send_idx [S, S, B]``: on shard ``i``, slot ``j`` holds the local
      rows peer ``j`` needs from ``i`` (pad 0).
    - ``perm``: the node order the plan was built under (``perm[new] =
      old``), or None for the natural order.
    - ``depth``/``ext``: the deep-halo plan, a depth-``d`` boundary
      exchanged once every ``d`` hops and advanced in between by the COO
      block ``ext = (esrc, edst, ew)`` over ``[local (Nl) | buffer
      (S*B)]``.
    """
    mode: str
    local: Tuple[np.ndarray, ...]
    halo: Tuple[np.ndarray, ...]
    send_idx: np.ndarray
    n_shards: int
    nodes_per_shard: int
    num_nodes: int
    b_max: int
    boundary_counts: np.ndarray
    payload_dtype: str = "float32"
    perm: Optional[np.ndarray] = None
    depth: int = 1
    ext: tuple = ()
    b_max_hop1: int = None
    bsr_tiles: Optional[np.ndarray] = None
    _shards: Dict = dataclasses.field(default_factory=dict, repr=False)

    def payload_itemsize(self) -> float:
        return _PAYLOADS[self.payload_dtype]

    def bytes_per_hop(self, feat: int, itemsize: int = None) -> int:
        """Bytes a shard sends a hop (the send buffer, amortized over the
        plan's ``depth``); int8 adds its f32 scale a row."""
        if itemsize is None:
            itemsize = self.payload_itemsize()
        per_row = feat * itemsize + (4 if self.payload_dtype == "int8"
                                     and itemsize == 1 else 0)
        return int(self.n_shards * self.b_max * per_row
                   / max(1, self.depth))

    def dense_gather_bytes(self, feat: int, itemsize: int = 4) -> int:
        """What an all-gather of the whole activation would move a hop."""
        return self.n_shards * self.nodes_per_shard * feat * itemsize

    def plan_bytes_per_device(self) -> int:
        """The plan's arrays a shard holds (operator blocks, send plan)."""
        leaves = (list(self.local) + list(self.halo) + [self.send_idx]
                  + list(self.ext))
        return sum(a.size * a.dtype.itemsize for a in leaves
                   ) // self.n_shards

    def ext_edges_max(self) -> int:
        """The most real ext-block edges of any shard: the extra work of a
        deep-halo in-buffer hop."""
        if not self.ext:
            return 0
        return int(np.count_nonzero(self.ext[2], axis=1).max())

    def dcn_bytes_per_hop(self, feat: int) -> int:
        raise _hier_unported()

    def shard(self, index: int, device) -> dict:
        """Shard ``index``'s slice of the plan as tensors on ``device``
        (built once per shard and device). In ``bsr`` mode the local block
        is ``(blocks, block_cols, row_ptr, block_rows)`` over the shard's
        real tiles only: the padding tiles sit at block row 0 after the
        real ones, so they would break the sorted rows K1 walks."""
        key = (index, str(device))
        if key in self._shards:
            return self._shards[key]

        def put(a):
            t = torch.as_tensor(np.ascontiguousarray(a), device=device)
            return t.long() if t.dtype == torch.int32 else t

        if self.mode == "bsr":
            blocks, brows, bcols = (a[index] for a in self.local)
            nb = int(self.bsr_tiles[index])
            n_br = self.nodes_per_shard // _BLOCK
            ptr = np.zeros(n_br + 1, np.int32)
            np.add.at(ptr, brows[:nb] + 1, 1)
            local = (put(blocks[:nb]),
                     torch.as_tensor(bcols[:nb], device=device),
                     torch.as_tensor(np.cumsum(ptr).astype(np.int32),
                                     device=device),
                     torch.as_tensor(brows[:nb], device=device))
        else:
            local = tuple(put(a[index]) for a in self.local)
        out = {"local": local,
               "halo": tuple(put(a[index]) for a in self.halo),
               "send_idx": put(self.send_idx[index]),
               "ext": tuple(put(a[index]) for a in self.ext)}
        self._shards[key] = out
        return out


def _permutation(order, g: Graph) -> Optional[np.ndarray]:
    if isinstance(order, np.ndarray):
        return order
    if order == "rcm":
        return rcm_order(g)
    if order != "natural":
        raise ValueError(f"unknown node order {order!r}")
    return None


def build_halo_spec(g: Graph, n_shards: int, mode: str = "auto",
                    order="natural", payload_dtype: str = "float32",
                    chips_per_host: int = None,
                    depth: int = 1) -> HaloSpec:
    """Partition ``g``'s nodes into ``n_shards`` contiguous blocks and
    build the boundary-exchange plan, as ``sgp_tpu``'s
    ``build_halo_spec`` does (the same arrays).

    ``order='rcm'`` (or an explicit permutation) reorders the nodes before
    the cut; :func:`shard_nodes` and :func:`gather_nodes` apply and undo
    it. ``mode='auto'`` is dense for ``Nl <= 4096`` and bsr above (bsr
    rounds ``Nl`` up to a multiple of 128). ``payload_dtype`` is the wire
    format of the exchanged rows (``float32``, ``bfloat16`` or ``int8``
    with f32 per-row absmax scales). ``depth=d`` exchanges the d-hop
    boundary once every d hops. The plan's arrays stay on the host (f32
    weights); :meth:`HaloSpec.shard` moves a shard's to its device.
    ``chips_per_host`` (the two-level plan) is not ported yet."""
    if chips_per_host is not None:
        raise _hier_unported()
    if payload_dtype not in _PAYLOADS:
        raise ValueError(f"unknown payload {payload_dtype!r}")
    n, s = g.num_nodes, n_shards
    perm = _permutation(order, g)
    if perm is not None:
        g = permute_nodes(g, perm)
    nl = -(-n // s)
    if mode == "auto":
        mode = "dense" if nl <= 4096 else "bsr"
    if mode == "bsr":
        nl = -(-nl // _BLOCK) * _BLOCK
    csr = g.to_scipy().tocsr()

    # pass 1: each shard's rows and what it needs from each peer
    need = [[None] * s for _ in range(s)]
    counts = np.zeros((s, s), np.int64)
    row_blocks = []
    for i in range(s):
        rows = csr[i * nl:min((i + 1) * nl, n)].tocsc()
        row_blocks.append(rows)
        for j in range(s):
            if j == i:
                continue
            block = rows[:, j * nl:min((j + 1) * nl, n)].tocoo()
            # stored zeros are no dependency
            nz = np.unique(block.col[block.data != 0])
            need[i][j] = nz
            counts[i, j] = len(nz)
    b_max_hop1 = max(1, int(counts.max()))
    if depth > 1:
        # widen the sets to the depth-hop in-neighbourhood (sorted local
        # indices per owner shard)
        for i in range(s):
            lo, hi = i * nl, min((i + 1) * nl, n)
            working = set(range(lo, hi))
            frontier = np.arange(lo, hi)
            for _ in range(depth):
                sub = csr[frontier].tocoo()
                deps = np.unique(sub.col[sub.data != 0])
                new = np.asarray([q for q in deps.tolist()
                                  if q not in working], np.int64)
                if not len(new):
                    break
                working.update(new.tolist())
                frontier = new
            halo_nodes = np.asarray(sorted(working - set(range(lo, hi))),
                                    np.int64)
            owners = halo_nodes // nl
            for j in range(s):
                if j == i:
                    continue
                nz = halo_nodes[owners == j] - j * nl
                need[i][j] = nz
                counts[i, j] = len(nz)
    b_max = max(1, int(counts.max()))

    # pass 2: the send plan and the halo entries in recv-layout columns
    send_idx = np.zeros((s, s, b_max), np.int32)
    halo_coo = [[] for _ in range(s)]
    for i in range(s):
        rows = row_blocks[i]
        for j in range(s):
            if j == i:
                continue
            nz = need[i][j]
            send_idx[j, i, :len(nz)] = nz      # j sends these rows to i
            if not len(nz):
                continue
            block = rows[:, j * nl:min((j + 1) * nl, n)].tocoo()
            keep = block.data != 0
            recv_col = j * b_max + np.searchsorted(nz, block.col[keep])
            halo_coo[i].append((block.row[keep], recv_col,
                                block.data[keep]))

    local, halo, tiles = _pack_blocks(mode, row_blocks, halo_coo, s, nl, n,
                                      b_max)
    ext = _build_ext(csr, need, s, nl, b_max) if depth > 1 else ()
    return HaloSpec(mode, local, halo, send_idx, s, nl, n, b_max, counts,
                    payload_dtype, perm, depth, ext, b_max_hop1, tiles)


def _build_ext(csr, need, s, nl, b_max):
    """The deep plan's halo-row advance: for every recv slot (a node some
    shard needs), its row of ``A`` with columns remapped into the shard's
    ``[local | buffer]`` state; columns outside the working set are
    dropped (they feed only rows past the still-exact horizon)."""
    per = []
    for i in range(s):
        lo = i * nl
        rows_e, cols_e, w_e = [], [], []
        for j in range(s):
            nzj = need[i][j]
            if j == i or nzj is None or not len(nzj):
                continue
            sub = csr[j * nl + nzj].tocoo()
            keep = sub.data != 0
            rr, cc, ww = sub.row[keep], sub.col[keep], sub.data[keep]
            owners = cc // nl
            esrc = np.full(len(cc), -1, np.int64)
            is_local = owners == i
            esrc[is_local] = cc[is_local] - lo
            for jj in np.unique(owners[~is_local]):
                m = (owners == jj) & ~is_local
                nzjj = need[i][jj]
                if nzjj is None or not len(nzjj):
                    continue
                loc = cc[m] - jj * nl
                pos_c = np.minimum(np.searchsorted(nzjj, loc), len(nzjj) - 1)
                inset = nzjj[pos_c] == loc
                e = np.full(len(loc), -1, np.int64)
                e[inset] = nl + jj * b_max + pos_c[inset]
                esrc[m] = e
            keep2 = esrc >= 0
            rows_e.append(j * b_max + rr[keep2])
            cols_e.append(esrc[keep2])
            w_e.append(ww[keep2])
        if rows_e:
            per.append((np.concatenate(cols_e), np.concatenate(rows_e),
                        np.concatenate(w_e).astype(np.float32)))
        else:
            per.append((np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.float32)))
    return _stack_coo(per)


def _stack_coo(per):
    """Per-shard COO triples padded with zero weights to one length."""
    s = len(per)
    ne = max(1, max(len(p[0]) for p in per))
    a = np.zeros((s, ne), np.int32)
    b = np.zeros((s, ne), np.int32)
    w = np.zeros((s, ne), np.float32)
    for i, (c, r, v) in enumerate(per):
        a[i, :len(c)], b[i, :len(c)], w[i, :len(c)] = c, r, v
    return a, b, w


def _pack_blocks(mode, row_blocks, halo_coo, s, nl, n, b_max):
    """Stack the per-shard local and halo blocks for one mode; returns
    ``(local, halo, bsr_tiles)`` (the real tile counts in bsr mode)."""
    def local_block(i):
        lb = row_blocks[i][:, i * nl:min((i + 1) * nl, n)].copy()
        lb.resize((nl, nl))
        return lb

    tiles = None
    if mode == "dense":
        local = (np.stack([local_block(i).toarray().astype(np.float32)
                           for i in range(s)]),)
    elif mode == "bsr":
        per = []
        for i in range(s):
            bsr = sp.csr_matrix(local_block(i)).tobsr(
                blocksize=(_BLOCK, _BLOCK))
            bsr.sort_indices()
            brows = np.repeat(np.arange(len(bsr.indptr) - 1,
                                        dtype=np.int32), np.diff(bsr.indptr))
            per.append((np.asarray(bsr.data, np.float32), brows,
                        np.asarray(bsr.indices, np.int32)))
        tiles = np.asarray([len(p[2]) for p in per], np.int64)
        nb = max(1, int(tiles.max()))
        blocks = np.zeros((s, nb, _BLOCK, _BLOCK), np.float32)
        brows = np.zeros((s, nb), np.int32)
        bcols = np.zeros((s, nb), np.int32)
        for i, (d, r, c) in enumerate(per):
            blocks[i, :len(c)], brows[i, :len(c)], bcols[i, :len(c)] = \
                d, r, c
        local = (blocks, brows, bcols)
    elif mode == "coo":
        per = []
        for i in range(s):
            lb = local_block(i).tocoo()
            keep = lb.data != 0
            per.append((lb.col[keep], lb.row[keep],
                        lb.data[keep].astype(np.float32)))
        local = _stack_coo(per)
    else:
        raise ValueError(f"unknown halo mode {mode!r}")

    if mode == "dense":
        a_halo = np.zeros((s, nl, s * b_max), np.float32)
        for i, coos in enumerate(halo_coo):
            for d, c, v in coos:
                a_halo[i, d, c] = v
        return local, (a_halo,), tiles
    per = []
    for coos in halo_coo:
        if coos:
            per.append((np.concatenate([e[1] for e in coos]),
                        np.concatenate([e[0] for e in coos]),
                        np.concatenate([e[2] for e in coos]
                                       ).astype(np.float32)))
        else:
            per.append((np.zeros(0, np.int64), np.zeros(0, np.int64),
                        np.zeros(0, np.float32)))
    return local, _stack_coo(per), tiles


def _coo_apply(src, dst, w, x, n_out: int):
    """``segment_sum(x[..., src, :] * w, dst)`` over the node axis."""
    msgs = x.index_select(-2, src) * w.to(x.dtype)[:, None]
    out = torch.zeros(x.shape[:-2] + (n_out, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(x.ndim - 2, dst, msgs)


def _apply_local(mode: str, local, x):
    """``A_local @ x`` for one shard, ``x [..., Nl, F]``."""
    if mode == "dense":
        (a,) = local
        return torch.matmul(a.float(), x.float()).to(x.dtype)
    if mode == "bsr":
        blocks, cols, row_ptr, rows = local
        if blocks.shape[0] == 0:      # a shard without stored tiles
            return torch.zeros_like(x)
        # fold the leading dims into the columns: [Nl, lead * F]
        x2 = x.movedim(-2, 0)
        y = bsr_spmm(blocks, cols, row_ptr, rows,
                     x2.reshape(x2.shape[0], -1))
        return y.reshape(x2.shape).movedim(0, -2)
    src, dst, w = local
    return _coo_apply(src, dst, w, x, x.shape[-2])


def _apply_halo(mode: str, halo, x_halo, nl: int):
    """``A_halo @ recv`` for one shard, ``x_halo [..., S*B, F]``."""
    if mode == "dense":
        (a,) = halo
        return torch.matmul(a.float(), x_halo.float()).to(x_halo.dtype)
    hsrc, hdst, hw = halo
    return _coo_apply(hsrc, hdst, hw, x_halo, nl)


def _exchange(send, group, payload: str):
    """``all_to_all`` of ``send [S*B, ..., F]`` (peer ``j``'s rows in
    section ``j``) in the wire format: bf16, or int8 rows quantized by
    their absmax with an f32 scale a row. Returns the rows in ``send``'s
    dtype."""
    if payload == "bfloat16":
        wire = collectives.all_to_all(send.to(torch.bfloat16), group)
        return wire.to(send.dtype)
    if payload == "int8":
        scale = send.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        q = torch.round(send / scale * 127.0).to(torch.int8)
        if group is not None:
            q = collectives.all_to_all(q, group)
            scale = collectives.all_to_all(scale.float(), group)
        return (q.float() * (scale / 127.0)).to(send.dtype)
    return send if group is None else collectives.all_to_all(send, group)


def _flat_exchange(x_local, send_idx, group, payload: str):
    """The recv buffer ``[..., S*B, F]``: the rows each peer needs,
    gathered by ``send_idx [S, B]`` and exchanged."""
    send = x_local.index_select(-2, send_idx.reshape(-1)).movedim(-2, 0)
    return _exchange(send.contiguous(), group, payload).movedim(0, -2)


def _update_halo(ext, x_local, x_halo):
    """Advance the recv rows one hop in the buffer (deep plan): ``ext`` is
    the COO block over ``[local (Nl) | buffer (S*B)]``. Rows past the
    exact horizon gather garbage and are never read while exact."""
    esrc, edst, ew = ext
    z = torch.cat([x_local, x_halo], dim=-2)
    return _coo_apply(esrc, edst, ew, z, x_halo.shape[-2])


def halo_khop(spec: HaloSpec, x: torch.Tensor, mesh: Mesh, k: int = 1,
              axis: str = "model", concat: bool = False) -> torch.Tensor:
    """K-hop propagation of this rank's slab ``x [..., Nl, F]`` (in the
    plan's node order, as :func:`shard_nodes` cuts it) with boundary-only
    exchange on ``mesh``'s ``axis``. Returns the k-th hop of the slab, or
    ``[x, Ax, ..., A^k x]`` along the features with ``concat``. Every rank
    of the axis calls it together."""
    if isinstance(axis, (tuple, list)):
        raise _hier_unported()
    if mesh.size(axis) != spec.n_shards:
        raise ValueError(f"plan for {spec.n_shards} shards, axis {axis!r} "
                         f"has {mesh.size(axis)} ranks")
    if x.shape[-2] != spec.nodes_per_shard:
        raise ValueError(f"slab has {x.shape[-2]} rows, the plan "
                         f"{spec.nodes_per_shard} a shard")
    plan = spec.shard(mesh.index[axis], x.device)
    group = mesh.group(axis)
    depth = max(1, spec.depth)
    outs = [x]
    x_halo = None
    for t in range(k):
        if t % depth == 0:
            x_halo = _flat_exchange(outs[-1], plan["send_idx"], group,
                                    spec.payload_dtype)
        else:
            x_halo = _update_halo(plan["ext"], outs[-2], x_halo)
        out = _apply_local(spec.mode, plan["local"], outs[-1])
        outs.append(out + _apply_halo(spec.mode, plan["halo"], x_halo,
                                      x.shape[-2]))
    return torch.cat(outs, dim=-1) if concat else outs[-1]


def _node_perm(spec: Optional[HaloSpec], n_rows: int) -> Optional[np.ndarray]:
    """The plan's permutation over ``n_rows`` rows: the true nodes'
    followed by identity on padding rows (a pre-padded input is
    natural-ordered with zero pad rows)."""
    if spec is None or spec.perm is None:
        return None
    n = spec.num_nodes
    if n_rows not in (n, spec.n_shards * spec.nodes_per_shard):
        raise ValueError(
            f"node dim {n_rows} matches neither N={n} nor the plan's padded "
            f"{spec.n_shards * spec.nodes_per_shard} (reordered plan: the "
            "node order of this input is unknown)")
    return np.concatenate([spec.perm, np.arange(n, n_rows,
                                                dtype=spec.perm.dtype)])


def shard_nodes(x: torch.Tensor, mesh: Mesh, axis: str = "data",
                node_axis: int = -2, spec: HaloSpec = None) -> torch.Tensor:
    """This rank's slab of ``x`` along ``node_axis``: the node dim padded
    with zeros to a multiple of the axis size (to ``S * Nl`` and in the
    plan's node order when ``spec`` is given), then the rank's contiguous
    block. ``x`` is the whole array, the same on every rank."""
    s, i = mesh.size(axis), mesh.index[axis]
    nd = node_axis % x.ndim
    perm = _node_perm(spec, x.shape[nd])
    if perm is not None:
        x = x.index_select(nd, torch.as_tensor(perm, device=x.device))
    nl = spec.nodes_per_shard if spec is not None else -(-x.shape[nd] // s)
    lo, hi = i * nl, (i + 1) * nl
    part = x.narrow(nd, min(lo, x.shape[nd]),
                    max(0, min(hi, x.shape[nd]) - lo))
    if part.shape[nd] == nl:
        return part.contiguous()
    pad = list(part.shape)
    pad[nd] = nl - part.shape[nd]
    return torch.cat([part, part.new_zeros(pad)], dim=nd)


def gather_nodes(x: torch.Tensor, mesh: Mesh, axis: str = "data",
                 node_axis: int = -2, spec: HaloSpec = None,
                 num_nodes: int = None) -> torch.Tensor:
    """The inverse of :func:`shard_nodes`: every rank's slab of a
    node-sharded result, all-gathered in shard order, the plan's
    permutation undone (``spec``), and cut to ``num_nodes`` (default: the
    plan's N, else the padded count)."""
    nd = node_axis % x.ndim
    whole = collectives.all_gather(x.movedim(nd, 0).contiguous(),
                                   mesh.group(axis)).movedim(0, nd)
    perm = _node_perm(spec, whole.shape[nd])
    if perm is not None:
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm), dtype=perm.dtype)
        whole = whole.index_select(nd, torch.as_tensor(inv,
                                                       device=x.device))
    if num_nodes is None and spec is not None:
        num_nodes = spec.num_nodes
    return whole if num_nodes is None else whole.narrow(nd, 0, num_nodes)
