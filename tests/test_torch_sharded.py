"""Port parity for the mesh (``cbird_tpu_torch/parallel/sharded.py`` and the
stores' mesh branches), on the CPU at small sizes.

- the shard steps against the JAX package's on the conftest's 8-device CPU
  mesh, on the same numpy-seeded inputs: distances, counts and scores
  equal; rows equal but among ties at the k boundary;
- every store under a mesh of CPU shards against the port's own
  single-device result, bit for bit: tombstones, shards with fewer rows
  than k, 8-, 3- and 6-shard meshes;
- two processes on gloo (the worker is this file, run as a script);
- the kernel wrappers' device check.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cbird_tpu.ops import color as jc
    from cbird_tpu.ops import pigeonhole as jp
    from cbird_tpu.ops.dct_hash import split_u64
    from cbird_tpu.parallel import sharded as js

from cbird_tpu_torch.ops import hamming as th
from cbird_tpu_torch.ops import pigeonhole as tp
from cbird_tpu_torch.parallel import sharded as ts

torch.set_num_threads(1)
CPU = torch.device("cpu")
T = 5  # threshold
BAD = 0x7FFF


def cpu_mesh(n: int = 8):
    return ts.make_mesh([CPU] * n)


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must force 8 cpu devices"
    return js.make_mesh()


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("CBIRD_TORCH_DEVICE", "cpu")


def planted(n: int, seed: int, pairs: int = 0, clusters=()):
    """uint64 hashes: random, ``pairs`` near copies (1-3 bit flips) and
    clusters of ``size`` rows within 2 bits of one row."""
    rng = np.random.default_rng(seed)
    h = rng.integers(1, 2**63, size=n, dtype=np.uint64)
    for _ in range(pairs):
        a, b = rng.integers(0, n, 2)
        h[b] = h[a] ^ np.uint64(sum(1 << int(x) for x in
                                    rng.choice(64, rng.integers(1, 4),
                                               replace=False)))
    for size in clusters:
        rows = rng.choice(n, size, replace=False)
        for r in rows[1:]:
            h[r] = h[rows[0]] ^ np.uint64(1 << int(rng.integers(64)))
    return h


def i64(h: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(h, np.uint64).view(np.int64))


def assert_topk(d_ref, i_ref, d, i, bad=BAD):
    """Distances equal; rows equal for every slot whose distance is below
    the needle's k-th (ties at the boundary may pick other rows); slots
    past the hits hold no row to compare."""
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    d, i = np.asarray(d), np.asarray(i)
    assert np.array_equal(d_ref, d)
    inside = (d < d[:, -1:]) & (d < bad)
    assert np.array_equal(np.where(inside, i_ref, -1),
                          np.where(inside, i, -1))


def same_lists(a, b):
    """Dense or sparse lists of (ids, values) equal entry for entry."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        a, b = [a[r] for r in sorted(a)], [b[r] for r in sorted(b)]
    assert len(a) == len(b)
    for (ia, va), (ib, vb) in zip(a, b):
        assert np.array_equal(ia, ib) and np.array_equal(va, vb)


# ---------------------------------------------------------------------------
# the mesh, and the shard steps against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape(n):
    """The devices factor as the JAX package's ``make_mesh``: 8 -> (2, 4),
    4 -> (2, 2), primes -> (1, n)."""
    mesh = cpu_mesh(n)
    assert mesh.devices.shape == js.make_mesh(jax.devices()[:n]).devices.shape
    assert mesh.axis_names == ("batch", "index")
    assert all(d == CPU for d in mesh.devices.flat)


def _hay(jmesh, n, seed, dead=0.02, **kw):
    h = planted(n, seed, **kw)
    valid = np.random.default_rng(seed + 1).random(n) > dead
    return h, valid


@pytest.mark.parametrize("n,q,k", [(4096, 24, 8), (32, 3, 16)])
def test_sharded_hamming_topk_matches_jax(jmesh, n, q, k):
    """K4 on every index shard, merged: 4096 rows (1024 a shard) and a
    store of 8 rows a shard below k = 16, which must merge back to k."""
    h, valid = _hay(jmesh, n, seed=n, pairs=n // 8, clusters=(20,))
    needles = np.concatenate([h[:q // 2], planted(q - q // 2, 7)])
    hs_j, vs_j = js.shard_index_arrays(jmesh, split_u64(h), valid)
    dj, ij = js.sharded_hamming_topk(jmesh, split_u64(needles), hs_j, vs_j,
                                     k=k)
    mesh = cpu_mesh()
    hs, vs = ts.shard_index_arrays(mesh, i64(h), torch.from_numpy(valid))
    d, i = ts.sharded_hamming_topk(mesh, i64(needles), hs, vs, k=k)
    assert d.shape == (q, k)
    assert_topk(dj, ij, d, i)


def test_sharded_all_pairs_step_matches_jax(jmesh):
    """Needles split over the batch axis, the haystack over index."""
    h, valid = _hay(jmesh, 1024, seed=3, pairs=200)
    dj, ij = js.sharded_all_pairs_step(jmesh, split_u64(h), split_u64(h),
                                       valid, k=4)
    d, i = ts.sharded_all_pairs_step(cpu_mesh(), i64(h), i64(h),
                                     torch.from_numpy(valid), k=4)
    assert_topk(dj, ij, d, i)


def test_sharded_lanes_topk_matches_jax(jmesh):
    """K5 on every shard (256-bit rows, near copies, tombstones), with the
    port's default bound (keeps every row) and with the index's bound."""
    rng = np.random.default_rng(11)
    hay = rng.integers(0, 2**32, (2048, 8), dtype=np.uint64).astype(np.uint32)
    hay[1000:1100] = hay[:100] ^ (rng.random((100, 8)) < 0.05) \
        .astype(np.uint32)
    valid = rng.random(2048) > 0.05
    needles = np.concatenate([hay[:12], rng.integers(0, 2**32, (4, 8),
                                                    dtype=np.uint64)
                              .astype(np.uint32)])
    h_j, v_j = js.shard_index_arrays(jmesh, hay, valid)
    dj, ij = js.sharded_lanes_topk(jmesh, needles, h_j, v_j, k=10)
    mesh = cpu_mesh()
    as64 = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int64))
    h_t, v_t = ts.shard_index_arrays(mesh, as64(hay), torch.from_numpy(valid))
    d, i = ts.sharded_lanes_topk(mesh, as64(needles), h_t, v_t, k=10)
    assert_topk(dj, ij, d, i)
    db, ib = ts.sharded_lanes_topk(mesh, as64(needles), h_t, v_t, k=10,
                                   bound=60)
    far = np.asarray(dj) >= 60
    assert np.array_equal(np.where(far, BAD, np.asarray(dj)), db)
    assert (np.asarray(ib)[far] == -1).all()


def test_sharded_color_topk_matches_jax(jmesh):
    """K6 and the chunks' stable sorts on every shard.  The scores equal,
    bit for bit, the JAX ``color_topk`` that each shard runs; the JAX
    package's own ``sharded_color_topk`` differs from that by an ulp on a
    few scores (XLA contracts the shard_map program's multiplies and adds
    otherwise), so it is held to within one ulp, rows where scores agree."""
    from test_torch_color import store_data
    nc, nn, _ = store_data(6, seed=21)
    nn[:3] = (0, 30, 31)
    hc, hn, hv = store_data(256, seed=22, dups=40)
    s1, i1 = (np.asarray(a) for a in jc.color_topk(nc, nn, hc, hn, hv, k=16))
    sj, ij = (np.asarray(a) for a in js.sharded_color_topk(
        jmesh, nc, nn, *js.shard_rows(jmesh, hc, hn, hv), k=16))
    mesh = cpu_mesh()
    s, i = ts.sharded_color_topk(mesh, torch.from_numpy(nc),
                                 torch.from_numpy(nn),
                                 *ts.shard_rows(mesh, hc, hn, hv), k=16)
    s, i = s.numpy(), i.numpy()
    assert np.array_equal(s1, s)
    inside = (s < s[:, -1:]) & (s < jc.BAD_SCORE)
    assert np.array_equal(np.where(inside, i1, -1), np.where(inside, i, -1))
    np.testing.assert_array_max_ulp(sj, s, maxulp=1)
    inside &= sj == s
    assert np.array_equal(np.where(inside, ij, -1), np.where(inside, i, -1))


def _video_rows(n: int, videos: int, seed: int):
    rng = np.random.default_rng(seed)
    h = planted(n, seed, pairs=n // 4)
    vidx = np.sort(rng.integers(0, videos, n)).astype(np.int32)
    frames = rng.integers(0, 5000, n).astype(np.int32)
    valid = rng.random(n) > 0.05
    return h, vidx, frames, valid


def test_sharded_frame_search_matches_jax(jmesh):
    """Per-video packed minima on every shard, one minimum across them."""
    h, vidx, frames, valid = _video_rows(1024, 37, seed=31)
    needles = np.concatenate([h[::97], planted(4, 32)])
    sh_j = js.shard_rows(jmesh, split_u64(h), vidx, frames, valid)
    dj, fj = js.sharded_frame_search(jmesh, split_u64(needles), *sh_j, 37)
    mesh = cpu_mesh()
    sh_t = ts.shard_rows(mesh, i64(h), *map(torch.from_numpy,
                                            (vidx, frames, valid)))
    d, f = ts.sharded_frame_search(mesh, i64(needles), *sh_t, 37)
    assert np.array_equal(np.asarray(dj), d.numpy())
    assert np.array_equal(np.asarray(fj), f.numpy())


@pytest.mark.parametrize("which", ["flat", "below"])
def test_sharded_counts_match_jax(jmesh, which):
    """K1-mma on every shard and one sum: ``sharded_flat_counts`` and
    ``sharded_count_below``."""
    h, valid = _hay(jmesh, 2048, seed=41, pairs=400, clusters=(30,))
    needles = h[::50]
    hs_j, vs_j = js.shard_index_arrays(jmesh, split_u64(h), valid)
    fj = js.sharded_flat_counts if which == "flat" else js.sharded_count_below
    want = np.asarray(fj(jmesh, split_u64(needles), hs_j, vs_j, T))
    ft = ts.sharded_flat_counts if which == "flat" else ts.sharded_count_below
    mesh = cpu_mesh()
    hs, vs = ts.shard_index_arrays(mesh, i64(h), torch.from_numpy(valid))
    got = ft(mesh, i64(needles), hs, vs, T).numpy()
    assert np.array_equal(want, got) and got.max() > 1


def test_sharded_self_count_matches_jax(jmesh):
    """The replicated triangle over every device against the JAX package's
    exact VPU form: blocks round the devices, K1-mma above the diagonal,
    K2-mma on the tiles that straddle it."""
    h, valid = _hay(jmesh, 4096, seed=51, pairs=600, clusters=(40,))
    rep = NamedSharding(jmesh, P())
    want = js.sharded_self_count(jmesh, jax.device_put(split_u64(h), rep),
                                 jax.device_put(valid, rep), T, 512, 1024)
    got = ts.sharded_self_count(cpu_mesh(), i64(h), torch.from_numpy(valid),
                                T, 512, 1024)
    assert np.array_equal(np.asarray(want), got) and got.sum() > 600


def test_self_counts_sparse_mesh_matches_jax(jmesh):
    """The pigeonhole count phase on a mesh (K3 chunks and K3-run tiles
    round the devices, states summed): the JAX package's hot rows and
    counts, with an over-long equal-key run."""
    h, valid = _hay(jmesh, 8192, seed=61, pairs=800, clusters=(2500,))
    n_valid = int(valid.sum())
    rep = NamedSharding(jmesh, P())
    jh_, jc_ = jp.self_counts_sparse(jax.device_put(split_u64(h), rep),
                                     jax.device_put(valid, rep), T, n_valid,
                                     mesh=jmesh)
    stats: dict = {}
    ph, pc = tp.self_counts_sparse(i64(h), torch.from_numpy(valid), T,
                                   n_valid, stats=stats, mesh=cpu_mesh())
    assert sum(stats["run_tiles"]) > 0  # the run tiles were dealt too
    assert np.array_equal(np.asarray(jh_), ph)
    assert np.array_equal(np.asarray(jc_), pc)


# ---------------------------------------------------------------------------
# stores on a mesh against the port on one device
# ---------------------------------------------------------------------------

def hash_store(n: int = 6000, seed: int = 71):
    h = planted(n, seed, pairs=500, clusters=(90,))
    ids = np.arange(1, n + 1, dtype=np.uint32)
    store = th.PackedHashStore(h, ids, device=CPU)
    store.remove(ids[np.random.default_rng(seed).random(n) < 0.02])
    return store


@pytest.mark.parametrize("shards", [8, 3, 6])
def test_hash_store_search_on_mesh(shards):
    """``search`` (the count gate, then K4 on every shard) equals one
    device's, 3- and 6-shard meshes padding the store to their multiple."""
    store = hash_store()
    needles = np.concatenate([store.hashes[::40], planted(50, 72)])
    want = store.search(needles, T, k=16)
    with th.use_mesh(cpu_mesh(shards)):
        got = store.search(needles, T, k=16)
        assert store._dev[0].shape[0] % ts.index_shards(store._dev_mesh) \
            == 0
    same_lists(want, got)


@pytest.mark.parametrize("route,shards", [("pigeonhole", 8), ("triangle", 8),
                                          ("triangle", 6)])
def test_hash_store_search_self_on_mesh(monkeypatch, route, shards):
    """``search_self`` on a mesh (the pigeonhole or the triangle count
    over every device, the top-k on every shard) equals one device's, with
    a duplicate cluster past k; the verify never rescans.  The whole copy
    of a 6-shard mesh is not padded to a multiple of 6."""
    if route == "triangle":
        monkeypatch.setattr(tp, "enabled", lambda: False)
    store = hash_store()
    kw = dict(k=64, rows=2048, cols=2048, min_n=1024, sparse=True)
    want = store.search_self(T, **kw)
    with th.use_mesh(cpu_mesh(shards)):
        got = store.search_self(T, **kw)
        assert store.rescanned == 0
        assert (store.pigeonhole is not None) == (route == "pigeonhole")
    assert len(want) > 500
    same_lists(want, got)


def video_store():
    from cbird_tpu_torch.ops.video_search import PackedVideoStore
    rng = np.random.default_rng(81)
    store = PackedVideoStore(device=CPU)
    base = [planted(40, 810 + v) for v in range(48)]
    for v in range(48):
        h = base[v].copy()
        if v >= 40:  # copies of videos 0-7, a bit flipped a frame
            h = base[v - 40] ^ np.uint64(1 << int(rng.integers(64)))
        store.add_video(1000 + v, np.arange(40) * 3, h)
    store.remove([1003, 1045])
    return store, np.concatenate(base[::5] + [planted(20, 89)])


def test_video_store_on_mesh():
    """``flat_hit_counts``, ``search_hits`` and ``search`` equal one
    device's on an 8-shard mesh."""
    store, needles = video_store()
    want = (store.flat_hit_counts(needles, T),
            store.search_hits(needles, T, k_cap=8),
            store.search(needles))
    with th.use_mesh(cpu_mesh()):
        got = (store.flat_hit_counts(needles, T),
               store.search_hits(needles, T, k_cap=8),
               store.search(needles))
    assert np.array_equal(want[0], got[0]) and want[0].max() >= 2
    assert [h is None for h in want[1]] == [h is None for h in got[1]]
    same_lists([h for h in want[1] if h is not None],
               [h for h in got[1] if h is not None])
    for a, b in zip(want[2], got[2]):
        assert np.array_equal(a, b)


def color_descs(n: int, seed: int):
    from test_torch_color import store_data
    from cbird_tpu_torch.ops.color import quantize_luv
    colors, counts, _ = store_data(n, seed=seed, dups=n // 5)
    descs = np.zeros((n, 33, 4), np.uint16)
    descs[:, :32, :3] = quantize_luv(colors)
    descs[:, :32, 3] = 1000
    descs[:, 32, 0] = counts
    return descs


@pytest.mark.parametrize("n,shards", [(160, 8), (40, 8), (160, 3)])
def test_color_store_on_mesh(n, shards):
    """``search`` (K6 on every shard) and ``search_self`` (the scan on a
    mesh) equal one device's ``search`` and bucketed ``search_self``; 40
    rows give 8-row shards below k = 16."""
    from cbird_tpu_torch.ops.color import PackedColorStore
    descs = color_descs(n, seed=91 + n)
    store = PackedColorStore(device=CPU)
    store.add(descs, np.arange(1, n + 1, dtype=np.uint32))
    store.remove([2, 5, 11])
    needles = list(descs[:12]) + [None]
    want = (store.search(needles, k=16), store.search_self(k=16))
    with th.use_mesh(cpu_mesh(shards)):
        got = (store.search(needles, k=16), store.search_self(k=16))
    same_lists(want[0], got[0])
    same_lists(want[1], got[1])
    assert sum(len(r[0]) for r in want[1]) > n


@pytest.mark.parametrize("t", [300, 40])
def test_desc_store_knn_on_mesh(t):
    """``_PackedDescStore.knn`` (K5 on every shard, bounded at the vote
    threshold) equals one device's; 40 rows give 5-row shards below
    k = 10."""
    from cbird_tpu_torch.index.cv_features_index import _PackedDescStore
    rng = np.random.default_rng(101)
    desc = rng.integers(0, 2**32, (t, 8), dtype=np.uint64).astype(np.uint32)
    desc[t // 2:t // 2 + 20] = desc[:20] ^ (rng.random((20, 8)) < 0.02) \
        .astype(np.uint32)
    store = _PackedDescStore(CPU)
    store.add(desc, np.repeat(np.arange(1, t // 4 + 1), 4).astype(np.uint32))
    store.remove([3])
    needles = desc[::7]
    want = store.knn(needles, 10, bound=80)
    with th.use_mesh(cpu_mesh()):
        got = store.knn(needles, 10, bound=80)
    assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])


def test_use_mesh_none_and_auto(monkeypatch):
    """``use_mesh(None)`` keeps a store on its own device; a CPU store
    never shards by itself; with nothing configured ``init_distributed``
    initialises nothing and counts one process."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert th._search_mesh(CPU) is None
    mesh = cpu_mesh(2)
    with th.use_mesh(mesh):
        assert th._search_mesh(CPU) is mesh
        with th.use_mesh(None):
            assert th._search_mesh(CPU) is None
    assert ts.init_distributed() == 1
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the wrappers' device check
# ---------------------------------------------------------------------------

def _wrapper_calls():
    from cbird_tpu_torch.ops import band_count, color_scores, count_below, \
        count_below_mma, hamming_lanes, hamming_topk
    meta = torch.device("meta")
    h = torch.zeros(64, dtype=torch.int64)
    v = torch.ones(64, dtype=torch.bool)
    hm = h.to(meta)
    lanes = torch.zeros(8, 4, dtype=torch.int64)
    cols = torch.zeros(4, 32, 3)
    cnt = torch.zeros(4, dtype=torch.int32)
    sh = torch.zeros(96, dtype=torch.int64)
    srow = torch.zeros(96, dtype=torch.int32)
    sv = torch.zeros(96, dtype=torch.bool)
    return {
        "count_below": lambda: count_below.count_below(h, hm, v, T),
        "count_below_mma": lambda: count_below_mma.count_below_mma(
            hm, h, v, T),
        "hamming_topk": lambda: hamming_topk.hamming_topk(h, h, v.to(meta),
                                                          4),
        "hamming_lanes_topk": lambda: hamming_lanes.hamming_lanes_topk(
            lanes, lanes.to(meta), v[:8], 4),
        "hamming_lanes_topk_popc":
            lambda: hamming_lanes.hamming_lanes_topk_popc(
                lanes.to(meta), lanes, v[:8], 4),
        "color_scores": lambda: color_scores.color_scores(
            cols, cnt, cols, cnt.to(meta), v[:4]),
        "band_counts": lambda: band_count.band_counts(
            sh, srow.to(meta), sv, [0xFF], T, 32),
        "run_tiles": lambda: band_count.run_tiles(
            srow.to(meta), sh, srow, sv, [(0, 2)], [0xFF], T, 32),
    }


@pytest.mark.parametrize("wrapper", sorted(_wrapper_calls()))
def test_wrapper_refuses_operands_on_two_devices(wrapper):
    """Every kernel wrapper checks that its operands lie on one device
    (it launches under that device) and raises ValueError if not."""
    with pytest.raises(ValueError, match="different devices"):
        _wrapper_calls()[wrapper]()


# ---------------------------------------------------------------------------
# two processes on gloo
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_two_processes_gloo():
    """``init_distributed``, ``make_multihost_mesh`` and the shard steps in
    two processes of two CPU shards each (gloo): the top-k (no
    collective), the all-pairs step (batch rows gathered), the triangle
    count and the pigeonhole count (states summed) against numpy."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
         os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"SHARDED-OK rank={r}" in out, out


def worker(rank: int, world: int, port: int) -> int:
    """One process of ``test_two_processes_gloo``."""
    n = ts.init_distributed(f"127.0.0.1:{port}", world, rank,
                            backend="gloo")
    assert n == world and ts.process_index() == rank
    mesh = ts.make_multihost_mesh(devices=[CPU, CPU])
    assert mesh.devices.shape == (world, 2) and mesh.local_rows == (rank,)

    h = planted(4096, 5, pairs=500, clusters=(60,))
    valid = np.random.default_rng(6).random(4096) > 0.02
    ref = np.concatenate([np.bitwise_count(h[r:r + 512, None] ^ h[None, :])
                          for r in range(0, 4096, 512)]).astype(np.int32)
    ref = np.where(valid[None, :], ref, BAD)
    hs, vs = ts.shard_index_arrays(mesh, i64(h), torch.from_numpy(valid))

    q = 10  # top-k: every process answers every needle
    d, i = ts.sharded_hamming_topk(mesh, i64(h[:q]), hs, vs, k=8)
    order = np.lexsort((np.broadcast_to(np.arange(4096), (q, 4096)),
                        ref[:q]), axis=1)[:, :8]
    want = np.take_along_axis(ref[:q], order, axis=1)
    assert np.array_equal(d.numpy(), np.where(want < BAD, want, BAD))
    assert np.array_equal(i.numpy()[want < BAD], order[want < BAD])

    d, i = ts.sharded_all_pairs_step(mesh, i64(h[:37]), hs, vs, k=4)
    want = np.sort(ref[:37], axis=1)[:, :4]
    assert d.shape == (37, 4) and np.array_equal(d.numpy(), want)

    tri = (ref < T) & valid[:, None] & np.triu(np.ones((4096, 4096), bool),
                                                1)
    counts = ts.sharded_self_count(mesh, i64(h), torch.from_numpy(valid), T,
                                   512, 1024)
    assert np.array_equal(counts, tri.sum(axis=1))
    ph = tp.self_counts(i64(h), torch.from_numpy(valid), T,
                        int(valid.sum()), mesh=mesh)
    assert np.array_equal(ph, tri.sum(axis=1))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"SHARDED-OK rank={rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(worker(*map(int, sys.argv[1:4])))
