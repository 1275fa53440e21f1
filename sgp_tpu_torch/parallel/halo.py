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
node-sharded result.

The two-level plan (``build_halo_spec(chips_per_host=C)``, ``halo_khop(axis=
("host", "chip"))`` on :func:`~sgp_tpu_torch.parallel.mesh.make_hier_mesh`'s
grid) exchanges the rows a shard needs from a peer of its own host with an
``all_to_all`` on the ``"chip"`` group, ships each remote host the union of
the rows any of its ranks needs once (``all_to_all`` on the ``"host"``
group), spreads those over the host (``all_gather`` on the ``"chip"``
group) and reassembles the flat recv layout with one gather, so the halo
blocks read it unchanged. The wire format stays compressed through both
cross-host legs.
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
from sgp_tpu_torch.parallel.mesh import Axis, Mesh

_BLOCK = 128
_PAYLOADS = {"float32": 4, "bfloat16": 2, "int8": 1}


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
    - ``hier``: the two-level plan, ``(send_intra [S, C, Bi], send_cross
      [S, H, Bc], assemble [S, S*B], C, H, b_intra, b_cross)`` (see
      :func:`_build_hier`), or None.
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
    hier: Optional[tuple] = None
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
        """Bytes a shard sends across hosts a hop under the two-level plan
        (0 without one): each boundary row once for each host that needs
        it, padded to ``b_cross``, amortized over the plan's ``depth``."""
        if self.hier is None:
            return 0
        *_, h, _, bc = self.hier
        per_row = feat * self.payload_itemsize() + (
            4 if self.payload_dtype == "int8" else 0)
        return int((h - 1) * bc * per_row / max(1, self.depth))

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
               "ext": tuple(put(a[index]) for a in self.ext),
               "hier": () if self.hier is None else tuple(
                   put(a[index]) for a in self.hier[:3])}
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
    boundary once every d hops. ``chips_per_host=C`` (``n_shards = H * C``)
    adds the two-level plan (:func:`_build_hier`; one host, ``C ==
    n_shards``, still builds it). The plan's arrays stay on the host (f32
    weights); :meth:`HaloSpec.shard` moves a shard's to its device."""
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
    hier = None
    if chips_per_host is not None and s >= chips_per_host:
        if s % chips_per_host:
            raise ValueError(
                f"n_shards ({s}) must be a multiple of chips_per_host "
                f"({chips_per_host}) for the two-level exchange")
        hier = _build_hier(need, s, b_max, chips_per_host)
    return HaloSpec(mode, local, halo, send_idx, s, nl, n, b_max, counts,
                    payload_dtype, perm, depth, ext, b_max_hop1, tiles,
                    hier)


def _build_hier(need, s, b_max, chips_per_host):
    """The two-level plan from the per-pair boundary sets. On shard ``i``:
    ``send_intra [C, Bi]`` the rows it sends each chip of its host,
    ``send_cross [H, Bc]`` the union of the rows any shard of each host
    needs from it; the recv buffer is ``[recv_intra (C*Bi) | allcross
    (C*H*Bc)]`` (``allcross[c, h]`` what shard ``(h, c)`` shipped this
    host) and ``assemble [S*B]`` maps every slot of the flat layout to its
    row there. Padding slots map to row 0: no halo entry reads them."""
    c_per = chips_per_host
    h_num = s // c_per
    b_intra = 1
    union = {}         # (sending shard, needing host) -> sorted rows
    for i in range(s):
        hi = i // c_per
        for j in range(s):
            if j == i or need[i][j] is None:
                continue
            nz = need[i][j]
            if j // c_per == hi:
                b_intra = max(b_intra, len(nz))
            else:
                key = (j, hi)
                union[key] = np.union1d(union[key], nz) \
                    if key in union else np.asarray(nz)
    b_cross = max([1] + [len(v) for v in union.values()])
    send_intra = np.zeros((s, c_per, b_intra), np.int32)
    send_cross = np.zeros((s, h_num, b_cross), np.int32)
    assemble = np.zeros((s, s * b_max), np.int32)
    for (j, h), u in union.items():
        send_cross[j, h, :len(u)] = u
    for i in range(s):
        hi, ci = divmod(i, c_per)
        for j in range(s):
            if j == i or need[i][j] is None:
                continue
            nz = need[i][j]
            hj, cj = divmod(j, c_per)
            if hj == hi:
                # shard j ships chip ci of its host these rows directly
                send_intra[j, ci, :len(nz)] = nz
                pos = cj * b_intra + np.arange(len(nz))
            else:
                pos = c_per * b_intra + (cj * h_num + hj) * b_cross \
                    + np.searchsorted(union[(j, hi)], nz)
            assemble[i, j * b_max:j * b_max + len(nz)] = pos
    return (send_intra, send_cross, assemble, c_per, h_num, b_intra,
            b_cross)


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


def _to_wire(send, payload: str) -> tuple:
    """``send`` in the wire format: bf16, or int8 rows quantized by their
    absmax with an f32 scale a row, or as it is."""
    if payload == "bfloat16":
        return (send.to(torch.bfloat16),)
    if payload == "int8":
        scale = send.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        return (torch.round(send / scale * 127.0).to(torch.int8),
                scale.float())
    return (send,)


def _from_wire(wire, payload: str, dtype) -> torch.Tensor:
    if payload == "int8":
        q, scale = wire
        return (q.float() * (scale / 127.0)).to(dtype)
    return wire[0].to(dtype)


def _exchange(send, group, payload: str):
    """``all_to_all`` of ``send [S*B, ..., F]`` (peer ``j``'s rows in
    section ``j``) in the wire format; returns the rows in ``send``'s
    dtype."""
    return _from_wire([collectives.all_to_all(w, group)
                       for w in _to_wire(send, payload)], payload,
                      send.dtype)


def _rows(x_local, idx) -> torch.Tensor:
    """The rows ``idx [P, B]`` of ``x_local [..., Nl, F]`` as ``[P*B, ...,
    F]``, peer ``p``'s in section ``p``."""
    return x_local.index_select(-2, idx.reshape(-1)).movedim(-2, 0) \
        .contiguous()


def _flat_exchange(x_local, send_idx, group, payload: str):
    """The recv buffer ``[..., S*B, F]``: the rows each peer needs,
    gathered by ``send_idx [S, B]`` and exchanged."""
    return _exchange(_rows(x_local, send_idx), group, payload).movedim(0, -2)


def _hier_exchange(x_local, hier, host_group, chip_group, payload: str):
    """The two-level exchange's recv buffer ``[..., S*B, F]`` in the flat
    layout: the intra-host rows by ``all_to_all`` on the chip group; each
    remote host's union rows by ``all_to_all`` on the host group, spread
    over the host by ``all_gather`` on the chip group, both legs in the
    wire format (dequantized after the gather); then ``assemble``."""
    send_intra, send_cross, assemble = hier
    recv_i = _exchange(_rows(x_local, send_intra), chip_group, payload)
    cross = _rows(x_local, send_cross)                    # [H*Bc, ..., F]
    wire = [collectives.all_gather(collectives.all_to_all(w, host_group),
                                   chip_group)
            for w in _to_wire(cross, payload)]            # [C*H*Bc, ...]
    buf = torch.cat([recv_i, _from_wire(wire, payload, cross.dtype)])
    return buf.index_select(0, assemble).movedim(0, -2)


def _update_halo(ext, x_local, x_halo):
    """Advance the recv rows one hop in the buffer (deep plan): ``ext`` is
    the COO block over ``[local (Nl) | buffer (S*B)]``. Rows past the
    exact horizon gather garbage and are never read while exact."""
    esrc, edst, ew = ext
    z = torch.cat([x_local, x_halo], dim=-2)
    return _coo_apply(esrc, edst, ew, z, x_halo.shape[-2])


def halo_khop(spec: HaloSpec, x: torch.Tensor, mesh: Mesh, k: int = 1,
              axis: Axis = "model", concat: bool = False) -> torch.Tensor:
    """K-hop propagation of this rank's slab ``x [..., Nl, F]`` (in the
    plan's node order, as :func:`shard_nodes` cuts it) with boundary-only
    exchange on ``mesh``'s ``axis``. Returns the k-th hop of the slab, or
    ``[x, Ax, ..., A^k x]`` along the features with ``concat``. ``axis=
    ("host", "chip")`` runs the two-level exchange on a
    :func:`~sgp_tpu_torch.parallel.mesh.make_hier_mesh` grid (a plan built
    with ``chips_per_host``). Every rank of the axis calls it together."""
    hierarchical = isinstance(axis, (tuple, list))
    if hierarchical:
        axis = tuple(axis)
        if spec.hier is None:
            raise ValueError("axis=(host, chip) needs a plan built with "
                             "chips_per_host (build_halo_spec(..., "
                             "chips_per_host=C))")
        host_ax, chip_ax = axis
        c, h = spec.hier[3:5]
        if (mesh.size(host_ax), mesh.size(chip_ax)) != (h, c):
            raise ValueError(f"plan for {h} hosts x {c} chips, the mesh "
                             f"has {mesh.size(host_ax)} x "
                             f"{mesh.size(chip_ax)}")
    if mesh.size(axis) != spec.n_shards:
        raise ValueError(f"plan for {spec.n_shards} shards, axis {axis!r} "
                         f"has {mesh.size(axis)} ranks")
    if x.shape[-2] != spec.nodes_per_shard:
        raise ValueError(f"slab has {x.shape[-2]} rows, the plan "
                         f"{spec.nodes_per_shard} a shard")
    plan = spec.shard(mesh.index[axis], x.device)
    payload = spec.payload_dtype

    def exchange(rows):
        if hierarchical:
            return _hier_exchange(rows, plan["hier"], mesh.group(host_ax),
                                  mesh.group(chip_ax), payload)
        return _flat_exchange(rows, plan["send_idx"], mesh.group(axis),
                              payload)

    depth = max(1, spec.depth)
    outs = [x]
    x_halo = None
    for t in range(k):
        if t % depth == 0:
            x_halo = exchange(outs[-1])
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


def shard_nodes(x: torch.Tensor, mesh: Mesh, axis: Axis = "data",
                node_axis: int = -2, spec: HaloSpec = None) -> torch.Tensor:
    """This rank's slab of ``x`` along ``node_axis``: the node dim padded
    with zeros to a multiple of the axis size (to ``S * Nl`` and in the
    plan's node order when ``spec`` is given), then the rank's contiguous
    block. ``x`` is the whole array, the same on every rank. ``axis`` may
    be the tuple ``("host", "chip")`` (the shard id ``host * C + chip``)."""
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


def gather_nodes(x: torch.Tensor, mesh: Mesh, axis: Axis = "data",
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
