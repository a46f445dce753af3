"""Checks the rates behind chip_smoke.py's bounds on one NVIDIA GPU.

    python3 chip_bounds.py [OUT_DIR]     (default build/bounds)

chip_smoke.py bounds the count kernels by instruction issue: 2 POPC a
pair for the popcount K1 (count_below.cu) and ~2 INT32 a pair for the
tensor-core K1-mma's epilogue (count_below_mma.cu), at a per-SM rate a
clock and the card's maximum SM clock.  This script reads what the
compiler made of both and what the card sustains:

  sass     cuobjdump -sass of the count kernels (K1, K1-mma), the top-k
           scan (K4) and the band counts (K3) into OUT_DIR/<name>.sass,
           and per loop (a backward branch) the opcode counts of its body
  probes   three kernels of 8 independent chains a thread, timed with
           CUDA events: POPC chained through an add (a += popc(a)), the
           epilogue's compare and add (x += d; c += x > lim), and K1's
           pattern (c += popc(a ^ i)); each one's opcode counts a step,
           and the instructions it sustains per clock per SM
  K1       the popcount K1 at Q=16384, N=2^21, t=5 (the K1 variants'
           shape, on operands made as chip_smoke's): 20 launches after
           K1-mma's two forms, as chip_smoke times them, and 100 alone,
           with the POPC a pair it needs over time and clock
  clocks   nvidia-smi clocks.sm, power.draw and the active clock event
           reasons sampled while each timed loop runs, beside
           clocks.max.sm; and in each probe block, the SM clock its run
           ran at (clock64 cycles over globaltimer ns)

Prints one JSON line per part and the card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np

PROBE_SRC = r"""
#include <cuda_runtime.h>
constexpr int CHAINS = 8;
__device__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
template <int OP>
__global__ void __launch_bounds__(256) probe(unsigned* out,
                                             unsigned long long* times,
                                             int iters, unsigned d,
                                             unsigned lim) {
  const unsigned long long c0 = clock64(), g0 = globaltimer();
  unsigned a[CHAINS], c[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) {
    a[j] = (blockIdx.x * 256u + threadIdx.x) * 0x9E3779B9u + j;
    c[j] = 0;
  }
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if (OP == 0) {         // POPC chained through an add
        a[j] += __popc(a[j]);
      } else if (OP == 1) {  // the epilogue's compare and add
        a[j] += d;
        c[j] += a[j] > lim;
      } else {               // K1's pattern: xor, POPC, add
        c[j] += __popc(a[j] ^ (unsigned)i);
      }
    }
  }
  unsigned s = 0;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += a[j] + c[j];
  if (s == 0x12345678u) out[0] = s;  // keeps the chains live
  if (threadIdx.x == 0) {  // SM cycles and ns of this block's run
    unsigned long long* tb = times + 4 * blockIdx.x;
    tb[0] = c0; tb[1] = clock64(); tb[2] = g0; tb[3] = globaltimer();
  }
}
extern "C" int cbird_probe(int op, void* out, void* times, int blocks,
                           int iters, unsigned d, unsigned lim,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto o = static_cast<unsigned*>(out);
  auto t = static_cast<unsigned long long*>(times);
  if (op == 0)
    probe<0><<<blocks, 256, 0, s>>>(o, t, iters, d, lim);
  else if (op == 1)
    probe<1><<<blocks, 256, 0, s>>>(o, t, iters, d, lim);
  else
    probe<2><<<blocks, 256, 0, s>>>(o, t, iters, d, lim);
  return (int)cudaGetLastError();
}
"""
CHAINS, THREADS = 8, 256
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")
TARGET = re.compile(r"BRA\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)")
LABEL = re.compile(r"^\s*(\.L_x_\d+):")


def smi(query: str) -> str:
    """The first line nvidia-smi prints for ``query`` ("" if none)."""
    return (subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines() + [""])[0]


def sass_functions(text: str) -> dict[str, list[str]]:
    """cuobjdump -sass output -> {function name: its lines}."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name:
            out[name].append(line)
    return out


def loops(lines: list[str]) -> list[dict]:
    """Each backward branch's body (from its target to the branch): its
    length and opcode counts (the opcode before its first dot).  Targets
    are addresses (``BRA 0x990``) or labels (``BRA `(.L_x_3)``)."""
    insns, at = [], {}  # (address, opcode, line); target -> index
    for line in lines:
        m = LABEL.match(line)
        if m:
            at[m.group(1)] = len(insns)
        m = INSN.search(line)
        if m:
            at[hex(int(m.group(1), 16))] = len(insns)
            insns.append((m.group(2), line))
    out = []
    for k, (op, line) in enumerate(insns):
        t = TARGET.search(line)
        if not (op.startswith("BRA") and t):
            continue
        key = t.group(1)
        start = at.get(hex(int(key, 16)) if key.startswith("0x") else key)
        if start is not None and start < k:
            body = insns[start:k + 1]
            ops = collections.Counter(o.split(".")[0] for o, _ in body)
            out.append({"to": key, "instructions": len(body),
                        "opcodes": dict(ops.most_common())})
    return out


class Clock:
    """nvidia-smi clocks.sm, power.draw and the active clock event reasons
    sampled in a thread while inside."""

    def __enter__(self):
        self.mhz, self.watts, self.reasons = [], [], set()
        self.stop = threading.Event()

        def poll():
            fields = "clocks.sm,power.draw,clocks_event_reasons.active"
            while not self.stop.is_set():
                row = smi(fields).split(",")
                try:
                    self.mhz.append(float(row[0].split()[0]))
                except ValueError:  # a field this nvidia-smi does not know
                    if fields == "clocks.sm":
                        return
                    fields = "clocks.sm"
                    continue
                if len(row) == 3:
                    self.watts.append(float(row[1].split()[0]))
                    self.reasons.add(row[2].strip())
        self.th = threading.Thread(target=poll, daemon=True)
        self.th.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.th.join()

    def summary(self) -> dict:
        a = np.array(self.mhz or [np.nan])
        w = np.array(self.watts or [np.nan])
        return {"samples": len(self.mhz), "min_mhz": float(a.min()),
                "median_mhz": float(np.median(a)), "max_mhz": float(a.max()),
                "max_watts": float(w.max()),
                "event_reasons": sorted(self.reasons)}


def build_probes(out_dir: str) -> str:
    """Compile PROBE_SRC with the package's nvcc flags into ``out_dir``.
    @return the library path"""
    from cbird_tpu_torch import _build
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "probe.cu")
    with open(src, "w") as f:
        f.write(PROBE_SRC)
    so = os.path.join(out_dir, "libprobe.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the probes:\n{proc.stderr}")
    return so


class Probes:
    """The probe kernels on the current CUDA device, 8 blocks per SM."""

    def __init__(self, torch, so: str):
        self.torch = torch
        self.lib = ctypes.CDLL(so)
        self.lib.cbird_probe.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.blocks = 8 * self.sms
        self.buf = torch.zeros(1, dtype=torch.int32, device="cuda")
        self.times = torch.zeros(4 * self.blocks, dtype=torch.int64,
                                 device="cuda")

    def run(self, op: int, iters: int) -> None:
        err = self.lib.cbird_probe(
            op, self.buf.data_ptr(), self.times.data_ptr(), self.blocks,
            iters, 0x9E3779B9, 0x6A09E667,
            self.torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"probe {op}: CUDA error {err}")

    def clock64_mhz(self) -> dict:
        """The SM clock of the last launch: its blocks' clock64 cycles over
        globaltimer ns (the timer CUDA events read)."""
        tb = self.times.view(-1, 4).cpu().numpy().astype(np.float64)
        mhz = (tb[:, 1] - tb[:, 0]) / (tb[:, 3] - tb[:, 2]) * 1e3
        return {"min": float(mhz.min()), "median": float(np.median(mhz)),
                "max": float(mhz.max())}

    def sm_clock_mhz(self, iters: int = 1 << 17) -> float:
        """The SM clock now: the median block of a short (~70 ms) run of
        K1's xor-POPC-add pattern."""
        self.run(2, iters)
        return self.clock64_mhz()["median"]


def timed_ms(torch, fn, reps: int) -> tuple[float, dict]:
    """Mean CUDA-event ms of ``reps`` calls after a warm-up, and the SM
    clock while they ran."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    with Clock() as clk:  # the launches are queued: sample while they run
        torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, clk.summary()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_bounds: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from cbird_tpu_torch import _build
    from cbird_tpu_torch.ops import count_below as cb
    out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        here, "build", "bounds")
    os.makedirs(out_dir, exist_ok=True)
    print(smi("name,power.limit"), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(smi("clocks.max.sm").split()[0])
    print(json.dumps({"sms": sms, "clocks_max_sm_mhz": max_mhz}), flush=True)

    so = build_probes(out_dir)
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = {}
    kernels = ("count_below", "count_below_mma", "hamming_topk", "band_count")
    for name, path in [(k, _build.build(k)) for k in kernels] + [("probe",
                                                                  so)]:
        text = subprocess.run([cuobjdump, "-sass", path], check=True,
                              capture_output=True, text=True,
                              timeout=300).stdout
        with open(os.path.join(out_dir, f"{name}.sass"), "w") as f:
            f.write(text)
        for fn, lines in sass_functions(text).items():
            sass[fn] = loops(lines)
            print(json.dumps({"sass": fn, "loops": sass[fn]}), flush=True)

    pr = Probes(torch, so)
    iters = 1 << 19
    for op, name in ((0, "popc_chained"), (1, "compare_add"),
                     (2, "xor_popc_add")):
        ms, clk = timed_ms(torch, lambda: pr.run(op, iters), 5)
        clk["clock64_mhz"] = pr.clock64_mhz()
        steps = pr.blocks * THREADS * CHAINS * iters
        fn = next(f for f in sass if f"probeILi{op}E" in f)
        body = max(sass[fn], key=lambda lp: lp["instructions"],
                   default={"opcodes": {}})
        # instructions a step: the loop body's, over its CHAINS steps
        per_step = {o: c / CHAINS for o, c in body["opcodes"].items()}
        row = {"probe": name, "ms": ms, "clock": clk,
               "opcodes_per_step": per_step}
        for o in ("POPC", "ISETP", "IADD3", "IMAD", "SEL", "LOP3", "VIADD"):
            if o in per_step:
                rate = steps * per_step[o] / (ms * 1e-3 * sms)
                row[f"{o}_per_clk_sm_at_max"] = rate / (max_mhz * 1e6)
                row[f"{o}_per_clk_sm_at_clock64"] = rate / (
                    clk["clock64_mhz"]["median"] * 1e6)
        print(json.dumps(row), flush=True)

    # the popcount K1 at the K1 variants' shape, on operands made as
    # chip_smoke's timing operands are: 20 launches after 20 of each form
    # of K1-mma (as chip_smoke times them), then 100 alone; after each, a
    # short probe reads the SM clock
    from chip_smoke import Smoke
    from cbird_tpu_torch.ops import count_below_mma as cm
    rng = np.random.default_rng(20261016)
    q, n = 16384, 1 << 21
    h64 = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    hay = torch.from_numpy(h64.view(np.int64)).cuda()
    vd = torch.from_numpy(rng.random(n) > 0.01).cuda()
    nd = torch.from_numpy(Smoke.flip_bits(
        h64[rng.integers(0, n, q)], rng.integers(0, 8, q), rng)
        .view(np.int64)).cuda()
    pairs = q * n
    for reps, mma_first in ((20, True), (100, False), (20, True)):
        if mma_first:
            for bf16 in (False, True):
                timed_ms(torch, lambda: cm.count_below_mma(nd, hay, vd, 5,
                                                           bf16=bf16), 20)
        ms, clk = timed_ms(torch, lambda: cb.count_below(nd, hay, vd, 5),
                           reps)
        pr.run(2, 1 << 15)
        clk["clock64_mhz_after"] = pr.clock64_mhz()
        print(json.dumps({
            "K1": f"Q={q} N=2^21 t=5", "launches": reps,
            "after_K1_mma": mma_first, "ms": ms, "clock": clk,
            "popc_per_clk_sm_at_max": 2 * pairs / (ms * 1e-3 * sms
                                                   * max_mhz * 1e6),
            "popc_per_clk_sm_at_clock64": 2 * pairs / (
                ms * 1e-3 * sms * clk["clock64_mhz_after"]["median"] * 1e6)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
