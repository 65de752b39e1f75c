#!/usr/bin/env python3
"""Measurements behind the design of the bf16 ``decode_attention`` body.

    python3 tools/decode_attention_probe.py

Needs a CUDA card and ``nvcc``; prints the card's name and power limit
first.  Not part of the port: it calls the kernel's C entry points itself
and builds two variants of ``src/repro_torch/csrc/decode_attention.cu``
through the hooks the source defines for it (into ``build/probe/``, in
parallel):

* ``p_hi_only`` (``-DDA_P_LO=0``): P·V without P's low bf16 half.  With
  an fp32 q over bf16 K/V, the normalised error of the kernel, of this
  variant and of q rounded to bf16 (plain version) at the shapes of
  ``chip_smoke.py`` phase 5 show what each half of the split buys.
* ``clocks`` (``DA_MARK``): ``clock64`` at each phase of block (0, 0) and
  the grid's first and last ``%globaltimer``, per split count.

Then the partial form's time at the starcoder2-3b serving shape (16 x
4096 bf16, 3072 valid, 24/2 heads of 128) for every split count from 1
to 8, the sweep behind ``kernel.splits_for``.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "probe"
#: the phases between DA_MARK(k) and DA_MARK(k + 1) in the bf16 body
PHASES = ("q_issue", "share_and_first_stages", "tile_loop", "merge")
CLOCKS_H = r'''
#include <cuda_runtime.h>
__device__ long long da_clk[5];
__device__ unsigned long long da_ns[4];
__device__ __forceinline__ void da_mark(int k) {
  if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) da_clk[k] = clock64();
  if (k == 0 || k == 4) {  // the grid's first and last start, first and last end
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (threadIdx.x == 0) { atomicMin(&da_ns[k / 2], t); atomicMax(&da_ns[k / 2 + 1], t); }
  }
}
#define DA_MARK(k) da_mark(k)
extern "C" int probe_read(long long* clk, unsigned long long* ns) {
  cudaMemcpyFromSymbol(clk, da_clk, sizeof(da_clk));
  return (int)cudaMemcpyFromSymbol(ns, da_ns, sizeof(da_ns));
}
extern "C" int probe_reset() {
  const unsigned long long ns[4] = {~0ull, 0ull, ~0ull, 0ull};
  return (int)cudaMemcpyToSymbol(da_ns, ns, sizeof(ns));
}
'''


def build(common) -> dict:
    """The base library (the port's own build) and the two variants."""
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "clocks.h").write_text(CLOCKS_H)
    flags = {"p_hi_only": ["-DDA_P_LO=0"],
             "clocks": ["-include", str(OUT / "clocks.h")]}
    procs = {name: subprocess.Popen(
        [common.nvcc_path(), *common.NVCC_FLAGS, *extra, "-o",
         str(OUT / f"lib{name}.so"), str(common.CSRC / "decode_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, extra in flags.items()}
    libs = {"base": common.load("decode_attention")}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def entry(lib, name: str):
    from repro_torch.kernels.decode_attention import kernel
    fn = getattr(lib, name)
    fn.argtypes = kernel._ARGS[name]
    fn.restype = ctypes.c_int
    return fn


def partial(lib, q, k, v, valid, splits: int):
    """The partial form over bf16 K/V in HBM at ``splits`` blocks."""
    import torch
    from repro_torch.kernels import common
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    out = (torch.empty((B, H, hd), **f32), torch.empty((B, H), **f32),
           torch.empty((B, H), **f32))
    err = entry(lib, "repro_decode_attention_partial")(
        q.data_ptr(), common.dtype_code(q.dtype), k.data_ptr(), v.data_ptr(),
        1, 0, k.stride(0), k.stride(1), k.stride(2), valid.data_ptr(),
        valid.stride(0), B, T, K, H // K, hd, splits, None, None, None,
        *(o.data_ptr() for o in out), common.stream_handle(q.device))
    common.check(err, "probe partial launch")
    return out


def normalised(lib, q, k, v, lengths):
    """The normalised form over bf16 K/V in HBM at the split rule's count."""
    import torch
    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attention import kernel
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.empty((B, H, hd), dtype=torch.float32, device=q.device)
    err = entry(lib, "repro_decode_attention")(
        q.data_ptr(), common.dtype_code(q.dtype), k.data_ptr(), v.data_ptr(),
        1, 0, k.stride(0), k.stride(1), k.stride(2), lengths.data_ptr(), B, T,
        K, H // K, hd, kernel.splits_for(B, K, T), None, None, None,
        out.data_ptr(), common.stream_handle(q.device))
    common.check(err, "probe normalised launch")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("decode_attention_probe: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attention import kernel, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = build(common)
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(7)

    # fp32 q over bf16 K/V: what q's and P's low halves each buy
    for B, H, K, hd, T in ((cs.SERVE_B, cs.SERVE_H, cs.SERVE_K, cs.SERVE_HD,
                            1024), (2, 16, 1, 256, 512)):
        for trial in range(3):
            q = torch.randn((B, H, hd), generator=g).to(dev)
            k, v = (torch.randn((B, T, K, hd), generator=g).to(
                dev, torch.bfloat16) for _ in range(2))
            lengths = torch.randint(1, T + 1, (B,), generator=g).to(
                dev, torch.int32)
            want = ref.decode_attention(q, k, v, lengths)
            errs = {name: float((normalised(libs[name], q, k, v, lengths)
                                 - want).abs().max())
                    for name in ("base", "p_hi_only")}
            rounded = float((ref.decode_attention(q.bfloat16(), k, v, lengths)
                             - want).abs().max())
            print(f"accuracy/fp32_q_bf16_kv/B{B}xH{H}xK{K}xhd{hd}xT{T}/"
                  f"trial{trial},kernel_err={errs['base']:.3g},"
                  f"p_hi_only_err={errs['p_hi_only']:.3g},"
                  f"bf16_rounded_q_err={rounded:.3g}", flush=True)

    B, H, K, hd, T = cs.SERVE_B, cs.SERVE_H, cs.SERVE_K, cs.SERVE_HD, cs.SERVE_T
    q = torch.randn((B, H, hd), generator=g).to(dev, torch.bfloat16)
    k, v = (torch.randn((B, T, K, hd), generator=g).to(dev, torch.bfloat16)
            for _ in range(2))
    valid = (torch.arange(T, device=dev)[None] < cs.SERVE_VALID).expand(
        B, T).contiguous()
    counts = range(1, kernel.MAX_SPLITS + 1)
    sweep = [cs.time_ms(lambda s=s: partial(libs["base"], q, k, v, valid, s),
                        iters=50, queue_ahead=True) for s in counts]
    print(f"split_sweep/rule={kernel.splits_for(B, K, T)}," + ",".join(
        f"s{s}_ms={t:.4f}" for s, t in zip(counts, sweep)), flush=True)

    lib = libs["clocks"]
    clk = (ctypes.c_longlong * 5)()
    ns = (ctypes.c_ulonglong * 4)()
    for s in counts:
        for _ in range(3):
            partial(lib, q, k, v, valid, s)
        torch.cuda.synchronize()
        lib.probe_reset()
        partial(lib, q, k, v, valid, s)
        torch.cuda.synchronize()
        lib.probe_read(clk, ns)
        parts = [f"{PHASES[i]}={clk[i + 1] - clk[i]}" for i in range(4)]
        print(f"clocks/s{s},block00_cycles," + ",".join(parts) +
              f",total={clk[4] - clk[0]},grid_start_spread_us="
              f"{(ns[1] - ns[0]) / 1e3:.2f},grid_end_spread_us="
              f"{(ns[3] - ns[2]) / 1e3:.2f},kernel_span_us="
              f"{(ns[3] - ns[0]) / 1e3:.2f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
