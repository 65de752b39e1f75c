#!/usr/bin/env python3
"""Measurements behind the design of the ``wkv6`` kernel.

    python3 tools/wkv6_probe.py [--parent DIR] [--only NAME,NAME]

Needs a CUDA card and ``nvcc``; prints the card's name and power limit
first.  Not part of the port: it calls the kernel's C entry point itself.

It builds variants of ``src/repro_torch/csrc/wkv6.cu`` through the
build-time hooks the source defines (``WKV_TI`` x ``WKV_TJ`` the hd-64
tile, ``WKV_CT`` steps a chunk, ``WKV_S`` ring stages, ``WKV_TWO_STEP``,
and ``WKV_MARK`` for ``clock64`` phase marks; into
``build/probe_wkv6/``, one ``nvcc`` each, in parallel), and with
``--parent DIR`` the same file of another tree (for instance the parent
commit unpacked into ``build/parent``) with the same flags.  For each it
prints registers, spills (``-Xptxas -v``) and the blocks an SM holds,
checks it against the plain version (prefill inputs, the model's decay
distribution at T = 33), and times it with the card queued ahead:

* the prefill shape of the rwkv slice: 16 x 1024 steps x 64 heads of 64,
  bf16 r/k/v, fp32 w;
* the decode shape: T = 1, four input sets in turn (134 MB, so the state
  does not stay in L2 between calls), as ``chip_smoke.py`` phase 7 does.

Every build is timed twice, in the order given and then reversed.  The
``clocks`` build (the default with phase marks) then splits block 0's
time at both shapes into prologue (state load, first chunks started),
waiting for a chunk (and the barrier), starting the next chunk's copies,
computing and epilogue (state store).
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "probe_wkv6"
#: (name, defines); the first is the source's default build
VARIANTS = (
    ("default", ()),
    ("one_step", ("-DWKV_TWO_STEP=0",)),
    ("one_step_ct16_s2", ("-DWKV_TWO_STEP=0", "-DWKV_CT=16", "-DWKV_S=2")),
    ("ct16_s2", ("-DWKV_CT=16", "-DWKV_S=2")),
    ("s2", ("-DWKV_S=2",)),
    ("s3", ("-DWKV_S=3",)),
    ("ct4_s8", ("-DWKV_CT=4", "-DWKV_S=8")),
    ("ti8_tj8", ("-DWKV_TI=8", "-DWKV_TJ=8")),
    ("ti8_tj16", ("-DWKV_TI=8", "-DWKV_TJ=16")),
    ("ti16_tj4", ("-DWKV_TI=16", "-DWKV_TJ=4")),
)
#: between WKV_MARK(k) and the next mark
PHASES = ("prologue", "wait", "copy", "compute", "epilogue")
CLOCKS_H = r'''
#include <cuda_runtime.h>
__device__ unsigned long long wk_sum[7];
__device__ unsigned long long wk_ns[6];
__device__ __forceinline__ void wk_mark(int k) {
  if (threadIdx.x != 0) return;
  if (blockIdx.x == 0) atomicAdd(&wk_sum[k], (unsigned long long)clock64());
  if (k == 0 || k == 6) {  // the grid's first and last start, first and last end
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    atomicMin(&wk_ns[k / 6 * 2], t);
    atomicMax(&wk_ns[k / 6 * 2 + 1], t);
    if (blockIdx.x == 0) wk_ns[4 + k / 6] = t;  // block 0's start and end
  }
}
#define WKV_MARK(k) wk_mark(k)
extern "C" int probe_read(unsigned long long* sum, unsigned long long* ns) {
  cudaMemcpyFromSymbol(sum, wk_sum, sizeof(wk_sum));
  return (int)cudaMemcpyFromSymbol(ns, wk_ns, sizeof(wk_ns));
}
extern "C" int probe_reset() {
  const unsigned long long sum[7] = {0, 0, 0, 0, 0, 0, 0};
  const unsigned long long ns[6] = {~0ull, 0ull, ~0ull, 0ull, 0ull, 0ull};
  cudaMemcpyToSymbol(wk_sum, sum, sizeof(sum));
  return (int)cudaMemcpyToSymbol(wk_ns, ns, sizeof(ns));
}
'''


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> tuple[dict, int]:
    """Registers and shared bytes of each hd-64 kernel (mangled name ->
    (registers, shared bytes)), and the number of functions that spill."""
    out, spills, fn = {}, 0, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln) or \
            re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and "Li64E" in fn:
            smem = re.search(r"(\d+) bytes smem", ln)
            out[fn] = (int(m.group(1)), int(smem.group(1)) if smem else 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and m.groups() != ("0", "0"):
            spills += 1
    return out, spills


def build(common, only, parent) -> dict:
    """name -> (library, ptxas log) for every variant, built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "clocks.h").write_text(CLOCKS_H)
    src = str(common.CSRC / "wkv6.cu")
    jobs = {name: (list(flags), src) for name, flags in VARIANTS
            if not only or name in only}
    jobs["clocks"] = (["-include", str(OUT / "clocks.h")], src)
    if parent:
        jobs["parent"] = ([], str(Path(parent) / "src" / "repro_torch" /
                                  "csrc" / "wkv6.cu"))
    procs = {name: subprocess.Popen(
        [common.nvcc_path(), *common.NVCC_FLAGS, *flags, "-o",
         str(OUT / f"lib{name}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (flags, path) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-4000:]}")
        libs[name] = (ctypes.CDLL(str(OUT / f"lib{name}.so")), log)
    return libs


def entry(lib):
    from repro_torch.kernels.wkv6 import kernel
    fn = lib.repro_wkv6
    fn.argtypes = kernel._ARGS
    fn.restype = ctypes.c_int
    return fn


def run(fn, r, k, v, w, u, s_in, s_out, y):
    """One launch of ``fn`` (a ``repro_wkv6``) on the current stream."""
    from repro_torch.kernels import common
    B, T, H, hd = r.shape
    common.check(fn(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), common.dtype_code(r.dtype),
        r.stride(0), r.stride(1), r.stride(2), w.data_ptr(),
        common.dtype_code(w.dtype), w.stride(0), w.stride(1), w.stride(2),
        u.data_ptr(), s_in.data_ptr(), s_out.data_ptr(), y.data_ptr(),
        B, T, H, hd, common.stream_handle(r.device)), "probe launch")


def blocks_per_sm(lib, regs_smem: dict) -> str:
    """Blocks an SM holds, for bf16 r/k/v and fp32 w at hd 64: the
    occupancy calculator's answer; for a build without the query (the
    parent: 64 threads a block), derived from its registers and shared
    memory (256-register allocation a warp, 1 KB reserved a block, 228
    KB an SM)."""
    fn = getattr(lib, "repro_wkv6_blocks_per_sm", None)
    if fn is not None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        out = ctypes.c_int(0)
        fn(1, 0, 64, ctypes.byref(out))
        return str(out.value)
    key = [n for n in regs_smem if "__nv_bfloat16fLi64E" in n] \
        or list(regs_smem)
    regs, smem = regs_smem[key[0]]
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = 65536 // (per_warp * 2)
    by_smem = (228 * 1024) // (smem + 1024)
    return f"{min(by_regs, by_smem, 32)}(derived)"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--parent", help="a tree whose wkv6.cu is timed beside")
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("wkv6_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.wkv6 import ref

    print(card_line(), flush=True)
    only = {n for n in args.only.split(",") if n}
    libs = build(common, only, args.parent)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16
    B, T, H, hd = cs.RWKV_B, cs.RWKV_T, cs.RWKV_H, cs.RWKV_HD

    prefill = cs._wkv_inputs(g, B, T, H, hd, bf16)
    decode = [cs._wkv_inputs(g, B, 1, H, hd, bf16) for _ in range(4)]
    ragged = cs._wkv_inputs(g, 2, 33, 2, hd, bf16, "model")
    want = {id(x): ref.wkv6(*x) for x in (prefill, ragged)}
    torch.cuda.synchronize()

    def outs(x):
        return (torch.empty_like(x[5]),
                torch.empty(x[0].shape, dtype=torch.float32, device=dev))

    timed = [n for n in libs if n != "clocks"]
    fns = {n: entry(lib) for n, (lib, _) in libs.items()}
    for name in timed:
        regs_smem, spills = ptxas_report(libs[name][1])
        errs, ok = [], True
        for x in (prefill, ragged):
            s_out, y = outs(x)
            run(fns[name], *x, s_out, y)
            for got, exp in zip((y, s_out), want[id(x)]):
                ok &= torch.allclose(got, exp, atol=cs.WKV_TOL["atol"],
                                     rtol=cs.WKV_TOL["rtol"])
            errs.append(max(float((got - exp).abs().max()) for got, exp in
                            zip((y, s_out), want[id(x)])))
        regs = max((r for r, _ in regs_smem.values()), default=0)
        print(f"build/{name},hd64_max_registers={regs},spilling_functions="
              f"{spills},blocks_per_sm={blocks_per_sm(libs[name][0], regs_smem)},"
              f"prefill_max_abs_err={errs[0]:.3g},"
              f"model_decay_T33_max_abs_err={errs[1]:.3g},"
              f"within_tol={int(ok)}", flush=True)

    p_out = outs(prefill)
    d_outs = [outs(x) for x in decode]
    turn = [0]

    def decode_call(fn):
        i = turn[0] = (turn[0] + 1) % len(decode)
        run(fn, *decode[i], *d_outs[i])

    times: dict = {n: [] for n in timed}
    for order in (timed, timed[::-1]):
        for name in order:
            fn = fns[name]
            pre = cs.time_ms(lambda: run(fn, *prefill, *p_out), iters=20,
                             queue_ahead=True)
            dec = cs.time_ms(lambda: decode_call(fn), iters=40,
                             queue_ahead=True)
            times[name].append((pre, dec))
    for name in timed:
        (p1, d1), (p2, d2) = times[name]
        print(f"time/{name},prefill_ms={p1:.4f}/{p2:.4f},"
              f"decode_ms={d1:.4f}/{d2:.4f}", flush=True)

    lib = libs["clocks"][0]
    sums = (ctypes.c_ulonglong * 7)()
    ns = (ctypes.c_ulonglong * 6)()
    for label, x, o in (("prefill", prefill, p_out),
                        ("decode", decode[0], d_outs[0])):
        for _ in range(3):
            run(fns["clocks"], *x, *o)
        torch.cuda.synchronize()
        lib.probe_reset()
        run(fns["clocks"], *x, *o)
        torch.cuda.synchronize()
        lib.probe_read(sums, ns)
        t = list(sums)
        wait, copy = t[3] - t[2], t[4] - t[3]
        parts = (t[1] - t[0], wait, copy, t[5] - t[1] - wait - copy,
                 t[6] - t[5])
        steps = x[0].shape[1]
        print(f"clocks/{label},block0_cycles," + ",".join(
            f"{p}={c}" for p, c in zip(PHASES, parts)) +
            f",total={t[6] - t[0]},compute_cycles_per_step="
            f"{parts[3] / steps:.1f},grid_start_spread_us="
            f"{(ns[1] - ns[0]) / 1e3:.2f},grid_end_spread_us="
            f"{(ns[3] - ns[2]) / 1e3:.2f},kernel_span_us="
            f"{(ns[3] - ns[0]) / 1e3:.2f},block0_us={(ns[5] - ns[4]) / 1e3:.2f},"
            f"block0_ghz={(t[6] - t[0]) / max(1, ns[5] - ns[4]):.3f}",
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
