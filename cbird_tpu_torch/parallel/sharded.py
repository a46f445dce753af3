"""Sharded search over a mesh of devices: placement, shard steps, merges.

Port of ``cbird_tpu/parallel/sharded.py`` on PyTorch.  The workload has
one collective need: a store's rows are split over devices, each device
scans its shard with the kernel a single device runs, and the per-shard
results are joined.  A top-k joins k candidates a needle and shard (the
merge keeps the k best by (distance, global row), so ties go to the lower
row, the single-device rule); a count joins by a sum, the video search by
a minimum.  No kernel is new: every shard step launches a kernel of the
port (K1-mma, K2-mma, K3, K3-run, K4, K5, K6) on one shard, and the joins
are plain PyTorch on small tensors, as the JAX package's are ``lax.top_k``,
``psum`` and ``pmin`` outside any Pallas kernel.

The mesh is a (batch, index) grid of ``torch.device``s.  ``index`` shards
a store's rows; ``batch`` splits the needles.  A grid may repeat a device
(eight shards on one card, or on the CPU): every shard then runs its own
launches, and every exchange is the same code with copies that stay on
the device.  The host drives the grid in one thread, device after device:
launches on two cards overlap only where nothing syncs between them, and
K4's wrapper reads its cursors back on every call, K5's and K6's callers
read their merged lists, so the shards of a step run one after another.

Across processes (``init_distributed``, ``make_multihost_mesh``): each
process drives one batch row, its local devices along ``index``.  Needles
that every device sees (``sharded_hamming_topk`` and the other replicated
steps) need no collective: every process holds every index shard and
answers them all.  What the JAX package reduces over every axis goes
through ``torch.distributed`` on the default group: ``all_reduce`` for the
self-search counts (``sharded_self_count``, ``ph_reduce_fn``) and
``all_gather_into_tensor`` for ``sharded_all_pairs_step``'s batch rows.
CPU tensors take gloo, CUDA tensors NCCL.

Arrays on a mesh: ``Sharded`` (rows split over ``index``, each shard on
the devices of its column) and ``Replicated`` (a copy on every local
device).  The JAX package's jitted step caches have no counterpart: the
step builders return plain functions.
"""

from __future__ import annotations

import os

import numpy as np
import torch

AXES = ("batch", "index")


class Mesh:
    """A (batch, index) grid of devices.  ``local_rows`` are the batch rows
    this process drives (every row in one process; its own in a
    multi-process mesh, where the other rows' devices are only names)."""

    def __init__(self, devices, axis_names=AXES, local_rows=None):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for b, row in enumerate(devices):
            for i, d in enumerate(row):
                grid[b, i] = torch.device(d)
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.local_rows = (tuple(range(grid.shape[0])) if local_rows is None
                           else tuple(local_rows))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def lead(self) -> torch.device:
        """Where merged results land: this process's first device."""
        return self.devices[self.local_rows[0], 0]

    def local_devices(self) -> list[tuple[int, torch.device]]:
        """(flat index in the grid, device) of every device this process
        drives, in grid order."""
        n_idx = self.devices.shape[1]
        return [(b * n_idx + i, self.devices[b, i])
                for b in self.local_rows for i in range(n_idx)]

    def __repr__(self) -> str:
        rows = [[str(d) for d in row] for row in self.devices]
        return (f"Mesh({rows}, axis_names={self.axis_names}, "
                f"local_rows={self.local_rows})")


def cuda_devices() -> list[torch.device]:
    """Every CUDA device of this process."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass the mesh's devices")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices=None, axes: tuple[str, str] = AXES) -> Mesh:
    """Factor the devices into a 2D (batch, index) mesh: batch splits the
    needles, index the haystack.  8 devices give (2, 4), 4 give (2, 2).
    @param devices default: every local CUDA device; a list may repeat one
           device"""
    devices = [torch.device(d) for d in
               (devices if devices is not None else cuda_devices())]
    n = len(devices)
    if n == 0:
        raise ValueError("make_mesh needs at least one device")
    bi = 1
    for f in (2, 3, 5, 7):
        while bi * f <= max(1, int(np.sqrt(n))) and n % (bi * f) == 0:
            bi *= f
    return Mesh([devices[b * (n // bi):(b + 1) * (n // bi)]
                 for b in range(bi)], axes)


# ---------------------------------------------------------------------------
# across processes
# ---------------------------------------------------------------------------

def _dist():
    import torch.distributed as dist
    return dist


def process_count() -> int:
    return _dist().get_world_size() if _initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if _initialized() else 0


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> int:
    """Multi-process bring-up: initialise ``torch.distributed`` once per
    process, from the arguments or the environment torchrun sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  With
    nothing configured a single process comes back as 1 and nothing is
    initialised.  After this, ``make_multihost_mesh`` builds the mesh and
    every shard step works unchanged.
    @param coordinator "host:port" of rank 0's rendezvous
    @param backend default: gloo for CPU tensors, and NCCL for CUDA tensors
           where CUDA is present
    @return process count"""
    dist = _dist()
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator is None and env.get("MASTER_ADDR"):
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator is None and num_processes is None:
        return 1
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator's address, "
                         "the process count and this process's rank")
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size()


def make_multihost_mesh(axes: tuple[str, str] = AXES,
                        devices=None) -> Mesh:
    """Global mesh of a multi-process deployment: the index axis (which
    carries the top-k merge) stays inside each process, the batch axis (no
    collective for replicated needles) spans the processes, one row each.
    On a single process this is ``make_mesh(devices)``.
    @param devices this process's devices (default: its CUDA devices);
           every process must bring as many"""
    world = process_count()
    if world == 1:
        return make_mesh(devices, axes)
    local = [torch.device(d) for d in
             (devices if devices is not None else cuda_devices())]
    n = torch.tensor([len(local), -len(local)], device=local[0])
    _dist().all_reduce(n, op=_dist().ReduceOp.MAX)
    if int(n[0]) != len(local) or int(-n[1]) != len(local):
        raise ValueError("every process must bring as many devices")
    return Mesh([local] * world, axes, local_rows=(process_index(),))


def _initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the processes, in place (without a process group:
    ``t``)."""
    if _initialized():
        _dist().all_reduce(t)
    return t


def _all_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """[R, ...] from each process -> [world * R, ...] in rank order
    (without a process group: ``t``)."""
    if not _initialized():
        return t
    out = t.new_empty((process_count() * t.shape[0],) + tuple(t.shape[1:]))
    _dist().all_gather_into_tensor(out, t.contiguous())
    return out


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

class Sharded:
    """One array's rows split over a mesh's index axis: shard i, rows
    [i * m, (i + 1) * m), on the device of column i of every local batch
    row."""

    def __init__(self, mesh: Mesh, parts: dict, shape: tuple):
        self.mesh = mesh
        self.parts = parts  # (batch row, index shard) -> tensor
        self.shape = shape
        self.rows_per_shard = shape[0] // mesh.devices.shape[1]

    def part(self, b: int, i: int) -> torch.Tensor:
        return self.parts[b, i]


class Replicated:
    """One array, a copy on every local device of a mesh."""

    def __init__(self, mesh: Mesh, a: torch.Tensor):
        self.copies = {dev: a.to(dev) for _, dev in mesh.local_devices()}
        self.shape = tuple(a.shape)

    def on(self, dev: torch.device) -> torch.Tensor:
        return self.copies[dev]


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(a))


def shard_rows(mesh: Mesh, *arrays):
    """Place each array's rows over the index axis (row counts must divide
    by the index-axis size: stores bucket with ``_bucket(multiple=)``).
    Shards that land on one device share one copy."""
    n_idx = mesh.devices.shape[1]
    out = []
    for a in arrays:
        t = _tensor(a)
        n = t.shape[0]
        if n % n_idx:
            raise ValueError(f"{n} rows do not divide over {n_idx} shards")
        m = n // n_idx
        placed: dict = {}
        parts = {}
        for b in mesh.local_rows:
            for i in range(n_idx):
                dev = mesh.devices[b, i]
                if (dev, i) not in placed:
                    placed[dev, i] = t[i * m:(i + 1) * m].to(dev)
                parts[b, i] = placed[dev, i]
        out.append(Sharded(mesh, parts, tuple(t.shape)))
    return tuple(out)


def index_shards(mesh: Mesh) -> int:
    return mesh.devices.shape[1]


def shard_index_arrays(mesh: Mesh, haystack, valid):
    """Place a store's arrays onto the mesh with index-axis sharding."""
    return shard_rows(mesh, haystack, valid)


def _sharded(mesh: Mesh, a) -> Sharded:
    return a if isinstance(a, Sharded) else shard_rows(mesh, a)[0]


def _row_slices(mesh: Mesh, q: int) -> list[tuple[int, int, int]]:
    """(batch row, first needle, end) of each local batch row, the needles
    split evenly among them."""
    rows = mesh.local_rows
    per = max(1, -(-q // len(rows)))
    out = [(b, j * per, min(q, (j + 1) * per)) for j, b in enumerate(rows)
           if j * per < q]
    return out or [(rows[0], 0, 0)]


def _per_row(mesh: Mesh, needles: tuple, local, merge, slices=None):
    """Every local (batch row, index shard) block: ``local(b, i, needle
    slice on the block's device)``; each batch row's shard results joined
    by ``merge`` on the lead device; the rows' results concatenated.
    @return the concatenated result (a tensor or a tuple of tensors)"""
    outs = []
    for b, lo, hi in slices or _row_slices(mesh, needles[0].shape[0]):
        parts = []
        for i in range(mesh.devices.shape[1]):
            dev = mesh.devices[b, i]
            parts.append(local(b, i, tuple(n[lo:hi].to(dev)
                                           for n in needles)))
        outs.append(merge(parts))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(c) for c in zip(*outs))
    return torch.cat(outs)


def _merge_gathered(local_d: list, local_i: list, rows_per_shard: int,
                    k_out: int | None = None, lead: torch.device | None = None):
    """Gather the per-shard [Q, k] candidates (shard order) onto ``lead``,
    offset each shard's rows (row -1, an empty slot, stays -1) by its first
    global row, and keep the ``k_out`` best in a stable order of the
    value: shard i's candidates precede shard i + 1's and each shard's are
    ascending by (value, row), so ties go to the lower global row.
    @param k_out merged width (the caller's k, which can exceed the
           per-shard clamped k); defaults to the local k, capped at s * k
    @return (values [Q, width], global rows [Q, width])"""
    lead = lead or local_d[0].device
    kk = local_d[0].shape[1]
    vals = torch.cat([d.to(lead) for d in local_d], 1)
    rows = torch.cat([torch.where(r >= 0, r + i * rows_per_shard, r).to(lead)
                      for i, r in enumerate(local_i)], 1)
    width = min(k_out or kk, len(local_d) * kk)
    v, sel = torch.sort(vals, dim=1, stable=True)
    return v[:, :width], torch.gather(rows, 1, sel[:, :width])


# ---------------------------------------------------------------------------
# shard steps
# ---------------------------------------------------------------------------

def _local_topk(needles, haystack, valid, k: int, bound: int):
    """Single-shard exact top-k (K4); k is clamped to the shard's rows: a
    shard can't contribute more candidates than it holds, and the merge
    restores the caller's k."""
    from ..ops.hamming_topk import hamming_topk
    return hamming_topk(needles, haystack, valid, min(k, haystack.shape[0]),
                        bound)


def sharded_hamming_topk(mesh: Mesh, needles: torch.Tensor, haystack,
                         valid, k: int = 64, recall: float = 0.99,
                         bound: int | None = None):
    """Distributed threshold / top-k search (K4 on each shard).

    needles [Q] int64 (every device sees them; the local batch rows split
    them), haystack [N] int64 and valid [N] bool ``Sharded`` over index.
    ``recall`` is accepted for the JAX signature: K4 is exact, so the
    result is exact at any recall.
    @param bound keep only rows at distance < bound (default: all)
    @return (dists [Q, k] int32, global rows [Q, k] int32) on the lead
            device, ascending by (distance, row); empty slots hold
            ``BAD_DIST`` and row -1"""
    from ..ops.hamming_topk import BINS
    haystack, valid = _sharded(mesh, haystack), _sharded(mesh, valid)
    bound = BINS if bound is None else bound
    m = haystack.rows_per_shard
    return _per_row(
        mesh, (needles,),
        lambda b, i, nd: _local_topk(nd[0], haystack.part(b, i),
                                     valid.part(b, i), k, bound),
        lambda parts: _merge_gathered([p[0] for p in parts],
                                      [p[1] for p in parts], m, k,
                                      mesh.lead))


def sharded_all_pairs_step(mesh: Mesh, needles: torch.Tensor, haystack,
                           valid, k: int = 16):
    """One all-pairs (-similar) step over the mesh: needles split over the
    batch axis (every row of every process: its share is computed where
    the row lives), haystack over index; each (b, i) block scans its
    (needle, row) block with K4, the index axis merges the top-k, and the
    batch rows are gathered across processes.
    @return (dists [Q, k] int32, global rows [Q, k] int32) on the lead
            device"""
    from ..ops.hamming_topk import BAD_DIST, BINS
    haystack, valid = _sharded(mesh, haystack), _sharded(mesh, valid)
    q = needles.shape[0]
    n_b = mesh.devices.shape[0]
    per = max(1, -(-q // n_b))
    m = haystack.rows_per_shard
    outs_d, outs_i = [], []
    for b in mesh.local_rows:
        lo, hi = min(q, b * per), min(q, (b + 1) * per)
        d, i = _per_row(
            mesh, (needles,),
            lambda b_, i_, nd: _local_topk(nd[0], haystack.part(b_, i_),
                                           valid.part(b_, i_), k, BINS),
            lambda parts: _merge_gathered([p[0] for p in parts],
                                          [p[1] for p in parts], m, k,
                                          mesh.lead),
            slices=[(b, lo, hi)])
        pad = per - d.shape[0]  # every row's share padded to one size
        outs_d.append(torch.nn.functional.pad(d, (0, 0, 0, pad),
                                              value=BAD_DIST))
        outs_i.append(torch.nn.functional.pad(i, (0, 0, 0, pad), value=-1))
    d = _all_gather_rows(torch.cat(outs_d))
    i = _all_gather_rows(torch.cat(outs_i))
    return d[:q], i[:q]


def sharded_lanes_topk(mesh: Mesh, needles: torch.Tensor, haystack, valid,
                       k: int = 10, bound: int | None = None):
    """Multi-lane (256-bit ORB descriptor) distributed k-nearest (K5 on
    each shard, with the descriptor index's bound): needles [Q, 4] int64,
    haystack [N, 4] int64 ``Sharded`` over index.
    @return (dists [Q, k] int32, global rows [Q, k] int32)"""
    from ..ops.hamming_lanes import BINS, hamming_lanes_topk
    haystack, valid = _sharded(mesh, haystack), _sharded(mesh, valid)
    bound = BINS if bound is None else bound
    m = haystack.rows_per_shard
    return _per_row(
        mesh, (needles,),
        lambda b, i, nd: hamming_lanes_topk(
            nd[0], haystack.part(b, i), valid.part(b, i), min(k, m), bound),
        lambda parts: _merge_gathered([p[0] for p in parts],
                                      [p[1] for p in parts], m, k,
                                      mesh.lead))


def sharded_color_topk(mesh: Mesh, n_colors: torch.Tensor,
                       n_counts: torch.Tensor, h_colors, h_counts, h_valid,
                       k: int = 64):
    """Distributed color descriptor scan: each shard's chunked chamfer scan
    (K6 and the chunks' stable sorts, ``ops/color.py`` ``color_topk``),
    then the same top-k merge.
    @return (scores [Q, k] float32 ascending, global rows [Q, k] int64)"""
    from ..ops.color import color_topk
    h_colors, h_counts, h_valid = (_sharded(mesh, a) for a in
                                   (h_colors, h_counts, h_valid))
    m = h_colors.rows_per_shard
    return _per_row(
        mesh, (n_colors, n_counts),
        lambda b, i, nd: color_topk(nd[0], nd[1], h_colors.part(b, i),
                                    h_counts.part(b, i), h_valid.part(b, i),
                                    k=min(k, m)),
        lambda parts: _merge_gathered([p[0] for p in parts],
                                      [p[1] for p in parts], m, k,
                                      mesh.lead))


def sharded_frame_search(mesh: Mesh, needles: torch.Tensor, hashes, vidx,
                         frame_no, valid, num_videos: int):
    """Distributed per-video minimum (video index, algo 4): frame rows
    sharded over index (video slots stay global); each shard reduces its
    frames into a packed [Q, V] ``(d << 24) | frame`` minimum, then one
    minimum across shards: distance dominates the packing, so the minimum
    carries the nearest frame along.
    @return (min_dist [Q, V] int32, 65 = no match; min_frame [Q, V])"""
    from ..ops.video_search import _FRAME_BITS, _FRAME_MASK, \
        frame_search_packed
    hashes, vidx, frame_no, valid = (_sharded(mesh, a) for a in
                                     (hashes, vidx, frame_no, valid))

    def pmin(parts):
        acc = parts[0].to(mesh.lead)
        for p in parts[1:]:
            acc = torch.minimum(acc, p.to(mesh.lead))
        return acc

    acc = _per_row(
        mesh, (needles,),
        lambda b, i, nd: frame_search_packed(
            nd[0], hashes.part(b, i), vidx.part(b, i), frame_no.part(b, i),
            valid.part(b, i), num_videos),
        pmin)
    return acc >> _FRAME_BITS, acc & _FRAME_MASK


def _sharded_mxu_counts(mesh: Mesh, needles: torch.Tensor, haystack, valid,
                        threshold: int) -> torch.Tensor:
    """Per-shard count on the tensor cores (``count_gate``: K1-mma) and one
    sum of the [Q] counts: the routing shared by ``sharded_count_below``
    and ``sharded_flat_counts``.  @return counts [Q] int32 (lead)"""
    from ..ops.count_below_mma import count_gate
    haystack, valid = _sharded(mesh, haystack), _sharded(mesh, valid)
    if needles.shape[0] == 0:
        return torch.zeros(0, dtype=torch.int32, device=mesh.lead)

    def psum(parts):
        acc = parts[0].to(mesh.lead)
        for p in parts[1:]:
            acc = acc + p.to(mesh.lead)
        return acc

    return _per_row(
        mesh, (needles,),
        lambda b, i, nd: count_gate(nd[0], haystack.part(b, i),
                                    valid.part(b, i), threshold),
        psum)


def sharded_flat_counts(mesh: Mesh, needles: torch.Tensor, haystack, valid,
                        threshold: int):
    """Distributed per-needle flat hit count over a frame-sharded store
    (the video pre-gate, ``ops/video_search.py`` ``flat_hit_counts``): the
    exact counts of every shard summed.  @return counts [Q] int32"""
    return _sharded_mxu_counts(mesh, needles, haystack, valid, threshold)


def sharded_count_below(mesh: Mesh, needles: torch.Tensor, haystack, valid,
                        threshold: int):
    """Distributed count below the threshold (the count gate of two-phase
    search): each shard counts its rows, one sum joins them."""
    return _sharded_mxu_counts(mesh, needles, haystack, valid, threshold)


# ---------------------------------------------------------------------------
# triangular N^2 self-search count phase over every mesh device
# ---------------------------------------------------------------------------

def _replicated(mesh: Mesh, a) -> Replicated:
    return a if isinstance(a, Replicated) else Replicated(mesh, _tensor(a))


def sharded_self_count(mesh: Mesh, haystack_rep, valid_rep, threshold: int,
                       rows: int, cols: int) -> np.ndarray:
    """Triangular self-search count phase, balanced over every mesh
    device.  The store is replicated (a copy on every device), so any
    device can take any tile; every live tile costs the same, so block b
    goes to device b mod C, which runs its tiles in order and chains its
    row counts.  Tiles wholly above the diagonal run K1-mma, those that
    straddle it K2-mma (``ops/count_below_mma.py`` ``self_tile``, as the
    single-device ``_classic_self_counts``): the JAX package masks every
    tile only because an SPMD program cannot branch per chip.  One sum
    across processes at the end.

    @param haystack_rep [n_pad] int64, valid_rep [n_pad] bool: tensors or
           ``Replicated``
    @return counts [n_pad] int32: per store row #{j > i: dist < threshold}
    """
    from ..ops.count_below_mma import self_tile
    haystack_rep = _replicated(mesh, haystack_rep)
    valid_rep = _replicated(mesh, valid_rep)
    n_pad = haystack_rep.shape[0]
    if n_pad % rows or n_pad % cols:
        raise ValueError(f"tiles {rows}x{cols} must divide {n_pad}")
    local = dict(mesh.local_devices())
    counts = torch.zeros(n_pad, dtype=torch.int32, device=mesh.lead)
    for j, rb in enumerate(range(0, n_pad, rows)):
        dev = local.get(j % mesh.size)
        if dev is None:
            continue  # another process's block
        h, v = haystack_rep.on(dev), valid_rep.on(dev)
        acc = torch.zeros(rows, dtype=torch.int32, device=dev)
        for cb in range(rb // cols * cols, n_pad, cols):
            acc = self_tile(acc, h, v, threshold, rb, cb, rows, cols,
                            masked=cb < rb + rows)
        counts[rb:rb + rows] = acc.to(mesh.lead)
    return _all_reduce(counts).cpu().numpy()


# ---------------------------------------------------------------------------
# pigeonhole-sorted N^2 count phase over every mesh device
# (ops/pigeonhole.py _sharded_block)
# ---------------------------------------------------------------------------

def ph_replicate(mesh: Mesh, *arrays) -> tuple:
    """A copy of each array on every local device (pigeonhole's sorted
    operands are read by every device)."""
    return tuple(_replicated(mesh, a) for a in arrays)


def ph_state(mesh: Mesh, m: int) -> dict:
    """Fresh per-device [m] int32 state: flat device index -> tensor."""
    return {c: torch.zeros(m, dtype=torch.int32, device=dev)
            for c, dev in mesh.local_devices()}


def ph_band_step_fn(mesh: Mesh, masks, s: int, t: int):
    """The sharded pigeonhole band step: every device runs K3 over its own
    range of the replicated sorted order and adds into its state.

    @return step(state, spans, sh, srow, svalid): ``spans`` maps a flat
            device index to its (p0, p1) range of sorted positions
            (multiples of s; absent = idle); the band of rows [p0, p1)
            reads columns up to p1 + s, so the launch takes that slice"""
    from ..ops.band_count import band_counts

    def step(state, spans, sh, srow, svalid):
        for c, dev in mesh.local_devices():
            if c not in spans:
                continue
            p0, p1 = spans[c]
            seg = slice(p0, p1 + s)
            state[c][seg] += band_counts(sh.on(dev)[seg], srow.on(dev)[seg],
                                         svalid.on(dev)[seg], masks, t, s)
        return state
    return step


def ph_run_step_fn(mesh: Mesh, masks, s: int, t: int):
    """The sharded oversized-run step: every device runs K3-run over its
    own list of dense [s, s] tiles.
    @return step(state, tiles, sh, srow, svalid): ``tiles`` maps a flat
            device index to its (ta, tb) list (a [P, 2] int32 tensor,
            copied to the device where it lies elsewhere, or a host list)"""
    from ..ops.band_count import run_tiles

    def step(state, tiles, sh, srow, svalid):
        for c, dev in mesh.local_devices():
            mine = tiles.get(c, ())
            if len(mine):
                if isinstance(mine, torch.Tensor):
                    mine = mine.to(dev).contiguous()
                run_tiles(state[c], sh.on(dev), srow.on(dev), svalid.on(dev),
                          mine, masks, t, s)
        return state
    return step


def ph_reduce_fn(mesh: Mesh):
    """Combine the per-device pigeonhole states: their sum on the lead
    device, then across processes.
    @return reduce(state) -> the block's csort vector"""
    def reduce(state):
        acc = None
        for c in sorted(state):
            part = state[c].to(mesh.lead)
            acc = part.clone() if acc is None else acc + part
        return _all_reduce(acc)
    return reduce
