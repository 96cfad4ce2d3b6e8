"""Multi-device execution of the exact and approx engines over a device mesh.

Counterpart of ``fastsk_tpu/parallel/sharding.py``: the mesh helpers, the
theta engines' mesh functions (``shard_rows``, ``pad_theta_batch``,
``exact_batch_update_sharded``, ``approx_batch_update_sharded``,
``sorted_batch_sharded``, ``sorted_batch_rowsharded``) and the packed
engine's two (``packed_round_sharded``, ``packed_ring_rowsharded``). The
mesh is a ``(rows, theta)`` grid of ``torch.device``s; a Python loop over
its entries takes the place of ``shard_map``. Entry ``(r, t)`` owns kernel
row block ``r`` and theta shard ``t``. Kernel launches are asynchronous and
the loops never wait on the device, so distinct cards can overlap (as far
as the host issues work fast enough: PERF.md §5); on one device named
several times (the tests' and the one-card smoke's stand-in for XLA's
virtual host devices) the entries run in turn.

The JAX collectives become:

- ``all_gather`` over rows: every row block's tensor moved to the entry's
  device (``gather_rows``); across processes, one sum of zero-filled full
  tensors;
- ``psum`` over theta: each entry's partial product added into its row
  block's accumulator. A process keeps one accumulator a row block it has
  entries in, and the host merge (``host_rows``) sums them across
  processes: integer sums commute, so this is the psum, deferred;
- the approx path's ``psum`` of the train-triangle variance: the sum of
  the row blocks' partial sums (``reduce_across`` between processes);
- the packed ring's ``ppermute``: ``ring_shift``, a ``.to(device)``
  within one process and point-to-point sends and receives between
  processes;
- the packed engine's ``host_gather`` (``process_allgather``) of its
  row blocks or replicas: each process lands its own in one host matrix
  and one sum merges the processes' (``reduce_across``).

A mesh whose entries belong to several processes (``parallel/
multihost.py``) loops over this process's entries only. Under gloo every
collective goes through host memory, explicitly; under nccl through this
process's card. The counters ``reduce_across.bytes`` and
``ring_shift.sent_bytes`` (``utils/observe.py``) count what this process
sends through them. Every function here is
integer-identical to the single-device engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.observe import count

if TYPE_CHECKING:
    from ..ops.pairs_packed_cuda import PackedRows

ROWS_AXIS = "rows"
THETA_AXIS = "theta"


def process_rank() -> int:
    """This process's rank in ``torch.distributed``, 0 when it is not
    initialized."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``(rows, theta)`` grid of devices.

    ``devices`` is the flat, row-major device list (entry ``(r, t)`` is
    ``devices[r * n_theta + t]``); ``shape`` maps each axis name to its
    size, as ``jax.sharding.Mesh.shape`` does. A device may appear more
    than once. ``ranks`` holds the process that owns each entry (empty:
    this process owns them all); a process touches its own entries
    only."""

    devices: Tuple[torch.device, ...]
    n_rows: int
    n_theta: int
    ranks: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.n_rows < 1 or self.n_theta < 1:
            raise ValueError(f"mesh axes must be >= 1; got {self.n_rows} x {self.n_theta}")
        if len(self.devices) != self.n_rows * self.n_theta:
            raise ValueError(
                f"{len(self.devices)} devices for a {self.n_rows} x {self.n_theta} mesh"
            )
        if self.ranks and len(self.ranks) != len(self.devices):
            raise ValueError(f"{len(self.ranks)} ranks for {len(self.devices)} entries")

    @property
    def shape(self) -> dict:
        return {ROWS_AXIS: self.n_rows, THETA_AXIS: self.n_theta}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def multiprocess(self) -> bool:
        """True when the entries belong to more than one process."""
        return len(set(self.ranks)) > 1

    def entry(self, r: int, t: int) -> int:
        return r * self.n_theta + t

    def is_local(self, e: int) -> bool:
        return not self.ranks or self.ranks[e] == process_rank()

    def local_entries(self) -> List[Tuple[int, int, int]]:
        """``(entry, r, t)`` of this process's entries, row-major."""
        return [
            (self.entry(r, t), r, t)
            for r in range(self.n_rows)
            for t in range(self.n_theta)
            if self.is_local(self.entry(r, t))
        ]

    def row_device(self, r: int) -> Optional[torch.device]:
        """The device of this process's first entry in row block ``r``
        (where it keeps that block's accumulator), None without one."""
        for t in range(self.n_theta):
            if self.is_local(self.entry(r, t)):
                return self.devices[self.entry(r, t)]
        return None

    @property
    def lead_device(self) -> torch.device:
        """The device of this process's first entry."""
        return self.devices[self.local_entries()[0][0]]


def make_mesh(n_rows: int, n_theta: int, devices=None) -> Mesh:
    """A ``(rows, theta)`` mesh of the first ``n_rows * n_theta`` visible
    CUDA devices, or of an explicit device list (which may repeat a
    device)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = n_rows * n_theta
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    return Mesh(tuple(devices[:need]), n_rows, n_theta)


def default_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """Split n_devices into (rows, theta) favoring a balanced 2-D mesh."""
    rows = 1
    for cand in range(int(np.sqrt(n_devices)), 0, -1):
        if n_devices % cand == 0:
            rows = cand
            break
    return rows, n_devices // rows


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int) -> np.ndarray:
    size = x.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple
    if target == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return np.pad(x, widths)


def _stage_device(mesh: Mesh) -> torch.device:
    """Where a collective runs: host memory under gloo, this process's card
    under nccl."""
    import torch.distributed as dist

    return torch.device("cpu") if dist.get_backend() == "gloo" else mesh.lead_device


def reduce_across(t: torch.Tensor, mesh: Mesh, op: str = "sum") -> torch.Tensor:
    """``t`` summed (or maxed) over the mesh's processes, in place; within
    one process it is ``t`` as it is."""
    if not mesh.multiprocess:
        return t
    import torch.distributed as dist

    buf = t.to(_stage_device(mesh))
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
    count("reduce_across.bytes", buf.numel() * buf.element_size())
    if buf is not t:
        t.copy_(buf)
    return t


def gather_rows(blocks: Dict[int, torch.Tensor], mesh: Mesh, full_shape, dim: int,
                dtype: torch.dtype) -> List[torch.Tensor]:
    """Every row block's tensor, in row order (JAX's ``all_gather`` over
    rows), from this process's ``blocks`` by row block. Within one process
    the blocks are returned as they lie; across processes each adds its
    blocks into a zero-filled ``full_shape`` tensor (``dim`` the rows), one
    sum merges them, and the blocks are slices of it on this process's lead
    device. Callers move each block to the device that reads it."""
    if not mesh.multiprocess:
        return [blocks[r] for r in range(mesh.n_rows)]
    n_local = full_shape[dim] // mesh.n_rows
    full = torch.zeros(full_shape, dtype=dtype, device=_stage_device(mesh))
    for r, b in blocks.items():
        full.narrow(dim, r * n_local, n_local).add_(b.to(full.device))
    full = reduce_across(full, mesh).to(mesh.lead_device)
    return [full.narrow(dim, r * n_local, n_local) for r in range(mesh.n_rows)]


def row_accumulators(mesh: Mesh, n_local: int, n_cols: int) -> Dict[int, torch.Tensor]:
    """Zero int32 ``[n_local, n_cols]`` accumulators, one a row block this
    process has entries in, on the device of its first such entry."""
    return {
        r: torch.zeros((n_local, n_cols), dtype=torch.int32, device=dev)
        for r in range(mesh.n_rows)
        if (dev := mesh.row_device(r)) is not None
    }


def host_rows(acc: Dict[int, torch.Tensor], mesh: Mesh, out: np.ndarray,
              n_local: int) -> np.ndarray:
    """Add the ``[n_local, cols]`` row-block accumulators, stacked, into
    the host matrix ``out`` (rows past its end are padding and dropped) on
    every process, and return it (JAX's ``host_gather``). Across processes
    the blocks of a row that several processes hold are summed: the
    deferred psum over theta."""
    if not mesh.multiprocess:
        for r, a in acc.items():
            rows = out[r * n_local : (r + 1) * n_local]
            rows += a[: rows.shape[0]].cpu().numpy()
        return out
    buf = torch.zeros((mesh.n_rows * n_local, out.shape[1]),
                      dtype=torch.from_numpy(out[:0]).dtype)
    for r, a in acc.items():
        buf[r * n_local : (r + 1) * n_local] += a.cpu()
    out += reduce_across(buf, mesh)[: out.shape[0]].numpy()
    return out


def replicate(mesh: Mesh, x: np.ndarray) -> Dict[int, torch.Tensor]:
    """``x`` on the device of each of this process's entries, one copy a
    distinct device (JAX's replicated ``P()``)."""
    copies: Dict[torch.device, torch.Tensor] = {}
    out = {}
    for e, _, _ in mesh.local_entries():
        dev = mesh.devices[e]
        if dev not in copies:
            copies[dev] = torch.as_tensor(x, device=dev)
        out[e] = copies[dev]
    return out


def shard_rows(mesh: Mesh, ids: np.ndarray, lengths: np.ndarray):
    """Pad the sequence axis to the rows-axis size and place each of this
    process's entries' row block on its device.

    Padded rows have length 0, so every window is masked invalid and they
    contribute exactly zero counts: their kernel rows and columns come out
    zero and the caller slices them off. Returns ``(ids, lengths,
    n_padded)``: ``ids`` and ``lengths`` map an entry to its ``[n_local,
    L]`` and ``[n_local]`` int32 block (one copy a row block and device)."""
    n_rows = mesh.n_rows
    ids_p = pad_to_multiple(np.asarray(ids, dtype=np.int32), 0, n_rows)
    lengths_p = pad_to_multiple(np.asarray(lengths, dtype=np.int32), 0, n_rows)
    nl = ids_p.shape[0] // n_rows
    placed: Dict[tuple, tuple] = {}
    ids_e, len_e = {}, {}
    for e, r, _ in mesh.local_entries():
        dev = mesh.devices[e]
        if (r, dev) not in placed:
            rows = slice(r * nl, (r + 1) * nl)
            placed[r, dev] = (torch.as_tensor(ids_p[rows], device=dev),
                              torch.as_tensor(lengths_p[rows], device=dev))
        ids_e[e], len_e[e] = placed[r, dev]
    return ids_e, len_e, ids_p.shape[0]


def pad_theta_batch(thetas: np.ndarray, n_theta: int):
    """Pad a theta batch to the theta-axis size; returns (thetas, mask)."""
    t = thetas.shape[0]
    thetas_p = pad_to_multiple(thetas, 0, n_theta)
    mask = np.zeros(thetas_p.shape[0], dtype=np.float32)
    mask[:t] = 1.0
    return thetas_p, mask


def exact_batch_update_sharded(
    k_acc: Dict[int, torch.Tensor],  # row block -> [n_local, Np] int32, updated in place
    ids: Dict[int, torch.Tensor],  # entry -> [n_local, L] (shard_rows)
    lengths: Dict[int, torch.Tensor],  # entry -> [n_local]
    thetas: np.ndarray,  # [Tp, k], Tp a multiple of the theta axis
    theta_mask: np.ndarray,  # [Tp] f32, 0 for padding
    *,
    mesh: Mesh,
    g: int,
    base: int,
    code_min: int,
    k1: int,
    b1: int,
    b2: int,
    row_chunk: int,
    route: str,
) -> Dict[int, torch.Tensor]:
    """``k_acc += sum_theta C_theta @ C_theta^T`` over a (rows, theta) mesh.

    Entry ``(r, t)`` builds the counts of row block ``r`` over theta shard
    ``t`` (contiguous, as ``P(THETA_AXIS)`` splits), masked; the shard's
    row blocks are gathered; the entry's product with each of them lands in
    its columns of row block ``r``'s accumulator (the psum over theta).
    One theta shard's counts are live at a time."""
    from ..ops import gkm

    tl = thetas.shape[0] // mesh.n_theta
    n_local = next(iter(ids.values())).shape[0]
    b = b1 * b2
    # the route's operand dtype (gkm.theta_route: never u8 on a mesh)
    dt = gkm.ROUTE_DTYPES[route]
    kw = dict(g=g, base=base, code_min=code_min, k1=k1, b1=b1, b2=b2, row_chunk=row_chunk)
    for t in range(mesh.n_theta):
        own = {}
        for e, r, tt in mesh.local_entries():
            if tt != t:
                continue
            dev = mesh.devices[e]
            th = torch.as_tensor(thetas[t * tl : (t + 1) * tl], dtype=torch.int64, device=dev)
            mask = torch.as_tensor(theta_mask[t * tl : (t + 1) * tl], device=dev).to(torch.int32)
            own[e, r] = gkm._counts_for_batch(ids[e], lengths[e], th, **kw) * mask[:, None, None]
        blocks = gather_rows({r: c for (_, r), c in own.items()}, mesh,
                             (tl, mesh.n_rows * n_local, b), 1, torch.int32)
        del own
        # each row block once as a product operand ([n_local, tl * B])
        flat = [gkm.batch_rows(blk, dt) for blk in blocks]
        del blocks
        for e, r, tt in mesh.local_entries():
            if tt != t:
                continue
            dev, acc = mesh.devices[e], k_acc[r]
            a = flat[r].to(dev)
            for r2, f in enumerate(flat):
                part = gkm.gram(a, f.to(dev)).to(torch.int32)
                acc[:, r2 * n_local : (r2 + 1) * n_local] += part.to(acc.device)
        del flat
    return k_acc


def approx_batch_update_sharded(
    state,  # ({row: k_sum [n_local, Np] int32}, {row: mean f32}, it [], done [])
    ids: Dict[int, torch.Tensor],
    lengths: Dict[int, torch.Tensor],
    thetas: np.ndarray,  # [T, k], the sample stream's order
    *,
    mesh: Mesh,
    g: int,
    base: int,
    code_min: int,
    k1: int,
    b1: int,
    b2: int,
    row_chunk: int,
    route: str,
    n_train: int,
    conv_delta: float,
    max_iters: int,
):
    """Rows-sharded Monte-Carlo batch with the reference stop rule.

    The same semantics as ``gkm.approx_batch_update`` on one device: thetas
    are consumed strictly in order, and the convergence statistic, the
    mean Welford variance over the packed train-pair triangle
    (fastsk_kernel.cpp:108-143), is the sum of the row blocks' partial
    sums each iteration. Approx shards rows only: the theta-axis entries of
    a row block would repeat its work, so row block ``r``'s state lives on
    entry ``(r, 0)`` (the keys of ``state``'s maps) and is computed once.
    ``it`` and ``done`` live on this process's lead device.

    Returns ``(state, sds)``, ``sds [T]`` the sd trace (NaN once done)."""
    from ..ops import gkm

    k_sum, mean, it, done = state
    n_local = next(iter(ids.values())).shape[0]
    home = {r: mesh.entry(r, 0) for r in k_sum}
    kw = dict(g=g, base=base, code_min=code_min, k1=k1, b1=b1, b2=b2, row_chunk=row_chunk)
    own = {}
    for r, e in home.items():
        th = torch.as_tensor(thetas, dtype=torch.int64, device=mesh.devices[e])
        own[r] = gkm._counts_for_batch(ids[e], lengths[e], th, **kw)
    blocks = gather_rows(own, mesh, (thetas.shape[0], mesh.n_rows * n_local, b1 * b2), 1,
                         torch.int32)
    del own
    blocks = [blk.to(gkm.ROUTE_DTYPES[route]) for blk in blocks]
    lead = it.device
    sds = []
    for j in range(thetas.shape[0]):
        it_new = it + 1
        new_mean, tri = {}, torch.zeros((), dtype=torch.float32, device=lead)
        ks = {}
        for r, e in home.items():
            dev = mesh.devices[e]
            a = blocks[r][j].to(dev)
            ks[r] = torch.cat(
                [gkm.gram(a, blk[j].to(dev)) for blk in blocks], dim=1
            ).to(torch.int32)
            new_mean[r], part = gkm.welford_partial(
                ks[r], mean[r], it_new.to(dev), row0=r * n_local, n_train=n_train)
            tri = tri + part.to(lead)
        sd, new_done = gkm.welford_finish(
            reduce_across(tri, mesh), it_new, done, n_train=n_train,
            conv_delta=conv_delta, max_iters=max_iters)
        # masked update: once done, this theta never happened
        for r, e in home.items():
            d = done.to(mesh.devices[e])
            k_sum[r] = torch.where(d, k_sum[r], k_sum[r] + ks[r])
            mean[r] = torch.where(d, mean[r], new_mean[r])
        it = torch.where(done, it, it_new)
        sds.append(torch.where(done, float("nan"), sd))
        done = new_done
    return (k_sum, mean, it, done), torch.stack(sds)


def sorted_batch_sharded(
    k_dev: Dict[int, torch.Tensor],  # entry -> [n, n] int32 private replica
    windows: Dict[int, torch.Tensor],  # entry -> [nfeat, g] int32 (replicate)
    seq_of: Dict[int, torch.Tensor],  # entry -> [nfeat] int64
    thetas: np.ndarray,  # [n_dev, T, k]
    live: np.ndarray,  # [n_dev, T] int32, 0 for padding
    *,
    mesh: Mesh,
    **static,
) -> Dict[int, torch.Tensor]:
    """Theta-sharded sorted passes: each entry runs its own theta
    sub-batch's passes (ops/sorted_theta.py) into its private kernel
    replica, the theta axis of the reference's thread pool
    (fastsk_kernel.cpp:53-93), with the merge deferred to a host sum of
    replicas. A padding theta would count zero, so it is not run."""
    from ..ops.sorted_theta import sorted_theta_pass

    for e, _, _ in mesh.local_entries():
        dev = mesh.devices[e]
        for theta, lv in zip(thetas[e], live[e]):
            if lv:
                th = torch.as_tensor(theta, dtype=torch.int64, device=dev)
                k_dev[e] += sorted_theta_pass(windows[e], seq_of[e], th, **static)
    return k_dev


def sorted_batch_rowsharded(
    k_rows: Dict[int, torch.Tensor],  # row block -> [n_rows, n] int32
    windows: Dict[int, torch.Tensor],
    seq_of: Dict[int, torch.Tensor],
    thetas: np.ndarray,  # [T_axis * Tb, k]
    live: np.ndarray,  # [T_axis * Tb] int32, 0 for padding
    *,
    mesh: Mesh,
    n_rows: int,
    **static,
) -> Dict[int, torch.Tensor]:
    """Rows x theta sharded sorted passes with O(N^2 / R) state a row
    block (KernelConfig.mesh_state="sharded").

    Entry ``(r, t)`` runs theta shard ``t``'s passes but computes only
    kernel row strip ``r`` (``[n_rows, n]``, ops/sorted_theta.py:
    sorted_theta_pass with ``row0``), added into the strip's accumulator
    (the psum over theta). The hash and sort are repeated across the rows
    axis: the price of never building an ``[n, n]`` pass."""
    from ..ops.sorted_theta import sorted_theta_pass

    tb = thetas.shape[0] // mesh.n_theta
    for e, r, t in mesh.local_entries():
        dev, acc = mesh.devices[e], k_rows[r]
        shard = slice(t * tb, (t + 1) * tb)
        for theta, lv in zip(thetas[shard], live[shard]):
            if lv:
                th = torch.as_tensor(theta, dtype=torch.int64, device=dev)
                acc += sorted_theta_pass(
                    windows[e], seq_of[e], th, row0=r * n_rows, n_rows=n_rows, **static
                ).to(acc.device)
    return k_rows


def ring_shift(held: Dict[int, PackedRows], mesh: Mesh) -> Dict[int, PackedRows]:
    """One step of JAX's ``ppermute`` around the ring of mesh entries: each
    of this process's entries ``d`` gets the table that entry ``(d + 1) mod
    D`` holds. ``held`` maps each of this process's entries to its
    ``PackedRows``; every entry's table has the same shape, so a receiver
    needs no size.

    Within one process a table moves with ``.to(device)`` (itself on a
    device named twice). Between processes its codes, ``seq_of`` and
    ``first_seq`` go by point-to-point sends and receives, all of them
    posted together (``dist.batch_isend_irecv``), so two ranks that send to
    each other do not deadlock; staged through host memory under gloo and
    this process's card under nccl. Every rank posts in the order of the
    receiving entry, so the messages between two ranks keep one order
    (nccl ignores tags)."""
    import torch.distributed as dist

    from ..ops.pairs_packed_cuda import PackedRows

    n = mesh.size
    stage = _stage_device(mesh) if mesh.multiprocess else None
    out, ops, landing = {}, [], []
    for d in range(n):
        src = (d + 1) % n
        if mesh.is_local(d) and mesh.is_local(src):
            out[d] = held[src].to(mesh.devices[d])
        elif mesh.is_local(d):  # entry src lives in another process
            like = held[d]
            bufs = [torch.empty_like(t, device=stage)
                    for t in (like.codes, like.seq_of, like.first_seq)]
            ops += [dist.P2POp(dist.irecv, b, mesh.ranks[src]) for b in bufs]
            landing.append((d, like, bufs))
        elif mesh.is_local(src):  # entry d lives in another process
            rows = held[src]
            for t in (rows.codes, rows.seq_of, rows.first_seq):
                buf = t.to(stage).contiguous()
                ops.append(dist.P2POp(dist.isend, buf, mesh.ranks[d]))
                count("ring_shift.sent_bytes", buf.numel() * buf.element_size())
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for d, like, bufs in landing:
        codes, seq_of, first_seq = (b.to(mesh.devices[d]) for b in bufs)
        out[d] = PackedRows(codes=codes, seq_of=seq_of, first_seq=first_seq,
                            tile=like.tile, c_pad=like.c_pad, alpha=like.alpha)
    return out


def packed_round_sharded(
    mats: Dict[int, torch.Tensor],  # entry -> [Np, Np] int64 private replica
    rows: Dict[int, PackedRows],  # entry -> the whole table on its device
    round_idx: int,
    *,
    mesh: Mesh,
    k: int,
    n_strips: int,
) -> Dict[int, torch.Tensor]:
    """One round-robin round of the packed (ragged) all-pairs engine.

    This process's entry ``d`` runs strip ``a = round_idx * D + d`` against
    all strips b >= a, one launch of kernel F's triangle
    (``ops/pairs_packed_cuda.py:packed_block``), adding into its PRIVATE
    replica: every row pair is handled by exactly one entry, so the merge
    is a sum of the replicas (on the host and across processes, by the
    engine). Round-robin assignment balances the triangular b loop."""
    from ..ops.pairs_packed_cuda import packed_block

    for d, _, _ in mesh.local_entries():
        a = round_idx * mesh.size + d
        if a < n_strips:
            packed_block(mats[d], rows[d], (a, a + 1), k=k)
    return mats


def packed_ring_rowsharded(
    blocks: Dict[int, torch.Tensor],  # entry -> [blk, Np] int64 row block
    shards: Dict[int, PackedRows],  # entry -> its own spd strips
    row0: Sequence[int],  # per entry: global row of its block[0]
    *,
    mesh: Mesh,
    spd: int,
    k: int,
    n_strips: int,
) -> Dict[int, torch.Tensor]:
    """Operand-sharded packed sweep: the window table is strip-sharded to
    match each entry's row block, and shards travel the ring once. At
    step s entry d holds the shard of entry (d + s) mod D and sweeps ALL
    its own live strips against ALL live visiting strips in one launch of
    kernel F (``ops/pairs_packed_cuda.py:packed_block``, landing rows ``si
    - row0`` of its block), then takes its upper neighbour's shard
    (``ring_shift``, JAX's ``ppermute``). At step 0 the shard is its own
    and the launch is F's triangle with its mirror, each unordered row
    pair once; the other steps are rectangles, every ordered pair. Dead
    strips (global id >= n_strips) are not launched. ``blocks`` and
    ``shards`` hold this process's entries only, and only they launch.
    Per-entry memory is the O(N^2 / D) row block plus two O(rows / D)
    shards. On a device named twice the visiting shard is the owner's own
    tensor, so nothing here writes into a shard."""
    from ..ops.pairs_packed_cuda import packed_block

    n_dev = mesh.size
    visiting = dict(shards)
    for s in range(n_dev):
        for d in blocks:
            n_a = min(spd, n_strips - d * spd)
            n_b = min(spd, n_strips - ((d + s) % n_dev) * spd)
            if n_a <= 0 or n_b <= 0:
                continue
            if s == 0:
                packed_block(blocks[d], shards[d], (0, n_a), k=k, strips_j=(0, n_a), row_off=row0[d])
            else:
                packed_block(
                    blocks[d], shards[d], (0, n_a), k=k, rows_j=visiting[d],
                    strips_j=(0, n_b), row_off=row0[d],
                )
        if s + 1 < n_dev:
            visiting = ring_shift(visiting, mesh)
    return blocks
