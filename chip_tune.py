"""Block shapes of the top-k scan (K4) and the band counts (K3), measured
on one NVIDIA GPU.

    python3 chip_tune.py

Writes every variant below of ``csrc/hamming_topk.cu`` and
``csrc/band_count.cu`` to ``build/tune/`` (a copy of the source with its
shape constants edited; the package always builds the sources as they
are), builds them with nvcc, one each, all at once; checks that each
variant's outputs equal the first variant's (or the plain band's); then
times each one with CUDA events (20 launches, two rounds, the variants
in turn), on chip_smoke.py's operands:

  K4  one first-pass scan (bound 5, k=64): Q=1 and Q=64 over a 10M-row
      store, Q=1024 over 2^20 rows.  Variants: threads a block
      (THREADS), haystack columns a thread (CPT), needles a block (TQ).
  K3  the band of chip_smoke's timed block (2^20 rows, s=2048, t=5 block
      0, with its planted over-long runs), and of the same block without
      them (random rows, 1% tombstones): the long runs' warps against the
      bulk.  Variants: warps a block (WARPS), warps that share the
      columns of 32 rows (by s as ``split_for`` sets it, or fixed), each
      taking SPAN columns in turn, columns staged through shared memory
      or read through L1.

The first variant of each list is the shape the sources hold.  Prints
the card's name and power limit, then one JSON line per variant.  Exits
non-zero when no CUDA device is visible or a variant disagrees.
"""

from __future__ import annotations

import concurrent.futures as cf
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

K4_VARIANTS = [  # (threads, columns a thread, needles a block)
    (256, 4, 128), (256, 2, 128), (256, 8, 128), (128, 4, 128),
    (512, 4, 128), (256, 4, 64), (256, 4, 256), (128, 8, 256)]
K3_VARIANTS = [  # (warps a block, warps a 32-row group (0: by s), span,
    # columns through shared memory (1) or L1 (0))
    (8, 0, 128, 1), (8, 1, 128, 1), (8, 2, 128, 1), (8, 4, 128, 1),
    (8, 8, 128, 1), (8, 4, 64, 1), (8, 4, 256, 1), (16, 0, 128, 1),
    (8, 0, 128, 0), (8, 1, 128, 0)]


def k4_edits(v) -> tuple:
    return (("constexpr int THREADS = 256;", f"constexpr int THREADS = {v[0]};"),
            ("constexpr int CPT = 4;", f"constexpr int CPT = {v[1]};"),
            ("constexpr int TQ = 128;", f"constexpr int TQ = {v[2]};"))


# the band's columns read through L1 instead of the per-warp stage
L1_EDITS = (("    c_hash[w][lane] = c;\n    c_row[w][lane] = crow;\n", ""),
            ("c_hash[w][j]", "__ldg(sh + min(q0 + j, n_tot - 1))"),
            ("c_row[w][j]", "__ldg(srow + q0 + j)"))


def k3_edits(v) -> tuple:
    edits = (("constexpr int WARPS = 8;", f"constexpr int WARPS = {v[0]};"),
             ("constexpr int SPAN = 128;", f"constexpr int SPAN = {v[2]};"))
    if v[1]:
        edits += (("const int split = split_for(s);",
                   f"const int split = {v[1]};"),)
    return edits + (() if v[3] else L1_EDITS)


def build_variant(name: str, edits: tuple) -> str:
    """``csrc/<name>.cu`` with each (old, new) edit made (old must occur),
    compiled as the package compiles it, into ``build/tune/``.
    @return the library path"""
    from cbird_tpu_torch import _build
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"chip_tune: {old!r} not in {name}.cu")
        src = src.replace(old, new)
    out = os.path.join(os.path.dirname(_build.BUILD_DIR), "tune")
    os.makedirs(out, exist_ok=True)
    stem = os.path.join(out, f"{name}-" + hashlib.sha256(
        src.encode()).hexdigest()[:16])
    with open(stem + ".cu", "w") as f:
        f.write(src)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o",
                           stem + ".so", stem + ".cu"],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {stem}.cu:\n{proc.stderr}")
    return stem + ".so"


def scan_launch(torch, lib, nd, h, v, k: int, bound: int):
    """One first-pass ``cbird_topk_scan`` of ``lib`` (no sort, no second
    pass), as a callable; its ``hist`` and ``cursor`` ride on it."""
    from cbird_tpu_torch import _build
    from cbird_tpu_torch.ops import hamming_topk as tk
    q, n = nd.numel(), h.numel()
    c = tk.capacity(k, n)
    hist = torch.empty((q, tk.BINS), dtype=torch.int32, device="cuda")
    cursor = torch.empty(q, dtype=torch.int32, device="cuda")
    keys = torch.empty(q * c, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check(lib, lib.cbird_topk_scan(
            nd.data_ptr(), None, q, h.data_ptr(), v.data_ptr(), n, bound,
            hist.data_ptr(), None, c, cursor.data_ptr(), keys.data_ptr(),
            stream), "topk_scan")
    launch.hist, launch.cursor = hist, cursor
    return launch


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_tune: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from cbird_tpu_torch import _build
    from cbird_tpu_torch.ops import band_count as bc
    from cbird_tpu_torch.ops import hamming_topk as tk
    print(chip_smoke.smi(), flush=True)
    s = chip_smoke.Smoke(torch)
    jobs = [("hamming_topk", v) for v in K4_VARIANTS] + [
        ("band_count", v) for v in K3_VARIANTS]
    with cf.ThreadPoolExecutor(len(jobs)) as ex:
        paths = list(ex.map(lambda j: build_variant(j[0], (
            k4_edits if j[0] == "hamming_topk" else k3_edits)(j[1])), jobs))
    libs = {}
    for (name, v), path in zip(jobs, paths):
        lib = ctypes.CDLL(path)
        if name == "hamming_topk":
            lib.cbird_topk_scan.argtypes = tk._SCAN_ARGS
            lib.cbird_topk_scan.restype = ctypes.c_int
        else:
            lib.cbird_band_counts.argtypes = bc._COMMON + [ctypes.c_void_p,
                                                           ctypes.c_void_p]
            lib.cbird_band_counts.restype = ctypes.c_int
        lib.cbird_error_string.argtypes = [ctypes.c_int]
        lib.cbird_error_string.restype = ctypes.c_char_p
        libs[(name, v)] = lib
    ok = True

    # K4: the scan alone at the query and batch shapes
    rng = np.random.default_rng(chip_smoke.SEED + 9)
    big = torch.from_numpy(rng.integers(0, 2**64, size=10_000_000,
                                        dtype=np.uint64).view(np.int64)).cuda()
    big_valid = torch.from_numpy(rng.random(big.numel()) > 0.01).cuda()
    pick = torch.from_numpy(rng.integers(0, 1 << 20, 1024)).cuda()
    shapes = {"Q=1 N=10M": (big[pick[:1]] ^ 5, big, big_valid),
              "Q=64 N=10M": (big[pick[:64]] ^ 5, big, big_valid),
              "Q=1024 N=2^20": (big[pick] ^ 5, big[:1 << 20],
                                big_valid[:1 << 20])}
    times = {v: {} for v in K4_VARIANTS}
    for shape, (nd, h, vd) in shapes.items():
        launch = {v: scan_launch(torch, libs[("hamming_topk", v)], nd, h,
                                 vd, 64, chip_smoke.T)
                  for v in K4_VARIANTS}
        ref = launch[K4_VARIANTS[0]]
        for v, fn in launch.items():
            fn()
            torch.cuda.synchronize()
            if not (torch.equal(fn.hist, ref.hist)
                    and torch.equal(fn.cursor, ref.cursor)):
                print(f"chip_tune: K4 {v} differs at {shape}",
                      file=sys.stderr)
                ok = False
        for _ in range(2):
            for v, fn in launch.items():
                times[v].setdefault(shape, []).append(s.event_ms(fn, 20))
    for v in K4_VARIANTS:
        print(json.dumps({"kernel": "K4 topk_scan", "threads": v[0],
                          "columns_per_thread": v[1], "needles_per_block":
                          v[2], "ms": times[v]}), flush=True)
    del big, big_valid

    # K3: the band of the smoke's timed block, and of a random one
    n, sz, _ = chip_smoke.K3_CHECKS[0]
    rng = np.random.default_rng(chip_smoke.SEED + 5)
    planted = s.k3_data(n, sz, rng)
    plain = (rng.integers(0, 2**64, size=n, dtype=np.uint64),
             rng.random(n) > 0.01)
    # each of the timed block's two plants alone: the 3s rows that share
    # block 0's key, and the 1.25 s copies of one hash
    long_run, copies = plain[0].copy(), plain[0].copy()
    long_run[n // 10:n // 10 + 3 * sz] = planted[0][n // 10:n // 10 + 3 * sz]
    copies[n // 2:n // 2 + 5 * sz // 4] = copies[9]
    stream = torch.cuda.current_stream().cuda_stream
    for block, (h64, valid) in (("timed block", planted),
                                ("random block", plain),
                                ("random + equal-key run", (long_run,
                                                            plain[1])),
                                ("random + copies", (copies, plain[1]))):
        ops, masks, _ = s.k3_block(h64, valid, chip_smoke.T, 0, sz)
        marr = bc._mask_array(masks)
        outs = {v: torch.empty_like(ops[1]) for v in K3_VARIANTS}

        def band(v):
            lib = libs[("band_count", v)]
            return lambda: _build.check(lib, lib.cbird_band_counts(
                *(a.data_ptr() for a in ops), ops[0].numel(), sz,
                ctypes.addressof(marr), len(masks), chip_smoke.T,
                outs[v].data_ptr(), stream), "band_counts")
        want = bc.band_counts_plain(*ops, masks, chip_smoke.T, sz)
        k3 = {v: [] for v in K3_VARIANTS}
        for v in K3_VARIANTS:
            band(v)()
            torch.cuda.synchronize()
            if not torch.equal(outs[v], want):
                print(f"chip_tune: K3 {v} differs from the plain band",
                      file=sys.stderr)
                ok = False
        for _ in range(2):
            for v in K3_VARIANTS:
                k3[v].append(s.event_ms(band(v), 20))
        for v in K3_VARIANTS:
            print(json.dumps({"kernel": "K3 band_counts", "block": block,
                              "warps_per_block": v[0],
                              "warps_per_32_rows": v[1],
                              "span": v[2], "shared_stage": v[3],
                              "ms": k3[v]}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
