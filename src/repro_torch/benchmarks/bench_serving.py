"""Serving-plane benchmark: shared-prefix paged KV + migration overlap.

Open-loop arrivals of grouped prompts — every group shares a long
prefix (system prompt / few-shot header) and diverges mid-page — run
through four engine configurations:

* ``nosharing``  — decode-replay prefill from token zero (baseline);
* ``sharing``    — radix-matched prefix pages attached BY REFERENCE,
  partial-page divergence copy-on-write, suffix-only replay;
* ``sync``       — sharing + a churning re-tier schedule through an
  async BulkMover with the submit+fence path (every migration is an
  exposed decode stall);
* ``overlap``    — same churn through the unfenced issue path:
  migrations run under decode compute and drain at epoch boundaries
  (hidden vs exposed time split via perfmodel.overlap_cost).

The stall accounting models the paper's testbed (``paper_topology()``),
as in the reference; on the card the KV pools are placed by backend, the
fast pool in HBM and the slow pool in pinned host memory, every decode
step runs ``decode_attention`` and every migration ``stream_copy``.

Metrics per mode: wall time, goodput (generated tokens / s), TTFT
p50/p99, prefill tokens avoided, migration stall/hidden/exposed time.
Asserted (full size): token-identical outputs across ALL modes,
sharing goodput >= 1.5x baseline, >= 30% prefill-token reduction, and
overlap stalls < synchronous stalls at equal migration traffic.  The
``--smoke`` lane asserts prefill-tokens-avoided > 0 and zero
correctness drift; ``main`` writes ``BENCH_serving_torch.json``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.benchmarks.common import stopwatch, synchronize
from repro_torch.core.mover import BulkMover
from repro_torch.core.policy import MemPolicy
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.tiers import paper_topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import registry
from repro_torch.serving.engine import ServingEngine

ARCH = "starcoder2-3b"
PAGE_T = 8

# full-size workload: 8 groups x 6 requests, 100-token shared prefix
# (12.5 pages: the half page exercises copy-on-write), 16 new tokens
FULL = dict(groups=8, per_group=6, pre_len=100, suf_len=4, new_tokens=16,
            max_len=128, max_batch=8, pool_pages=128, churn_every=8)
SMOKE = dict(groups=3, per_group=3, pre_len=20, suf_len=4, new_tokens=6,
             max_len=32, max_batch=4, pool_pages=32, churn_every=4)
MODES = ("nosharing", "sharing", "sync", "overlap")


def _workload(cfg, p, seed=0):
    """Grouped shared-prefix prompts + open-loop arrival steps."""
    rng = np.random.default_rng(seed)
    prompts = []
    for _ in range(p["groups"]):
        pre = rng.integers(0, cfg.vocab_padded, size=p["pre_len"]).tolist()
        for _ in range(p["per_group"]):
            suf = rng.integers(0, cfg.vocab_padded,
                               size=p["suf_len"]).tolist()
            prompts.append(pre + suf)
    order = rng.permutation(len(prompts))
    prompts = [prompts[i] for i in order]
    # open loop: Poisson arrivals in engine-step time, ~2 steps apart
    gaps = rng.exponential(scale=2.0, size=len(prompts))
    arrive = np.floor(np.cumsum(gaps)).astype(int)
    return prompts, arrive


def _run_mode(mode, cfg, params, p, prompts, arrive, device):
    topo = paper_topology()
    share = mode != "nosharing"
    churn = mode in ("sync", "overlap")
    mover = (BulkMover(topo, asynchronous=True, batch_size=16,
                       device=device) if churn else None)
    tel = Telemetry()
    eng = ServingEngine(
        cfg, params, max_batch=p["max_batch"], max_len=p["max_len"],
        policy=MemPolicy.from_slow_fraction(topo.fast.name,
                                            topo.slow.name, 0.5),
        page_t=PAGE_T, topology=topo, mover=mover, telemetry=tel,
        prefix_pages=p["pool_pages"] if share else 0,
        overlap=(mode == "overlap"), device=device)
    if device.type == "cuda":  # pools placed by backend, not by tier name
        assert eng.cache.k_parts[0].is_cuda and \
            eng.cache.k_parts[1].is_pinned(), eng.cache.backend
    fracs = (0.25, 0.5)
    moved = 0
    next_req = 0
    synchronize(device)
    wall = stopwatch(device)
    step_i = 0
    while next_req < len(prompts) or eng.queue or any(eng.slots):
        while next_req < len(prompts) and arrive[next_req] <= step_i:
            eng.submit(prompts[next_req], max_new_tokens=p["new_tokens"])
            next_req += 1
        eng.step()
        step_i += 1
        if churn and step_i % p["churn_every"] == 0:
            # deterministic migration churn (stands in for a Caption
            # walk's actuations): re-tier the batch population through
            # the mover, fenced (sync) or unfenced (overlap)
            eng._drain_migrations()
            b0 = mover.bytes_submitted
            stall = stopwatch(device)
            eng.cache = eng.cache.repartition_fraction(
                fracs[(step_i // p["churn_every"]) % 2],
                pinned_slots=eng.pinned_slots, mover=mover,
                telemetry=tel, fast_tier=topo.fast.name,
                slow_tier=topo.slow.name, source=eng.buffer_name,
                donate=eng.donate_kv, wait=not eng.overlap)
            eng._account_actuation(mover.bytes_submitted - b0, stall())
            moved += mover.bytes_submitted - b0
    done = eng.run_until_drained()
    wall_s = wall()
    if mover is not None:
        mover.close()
    done = sorted(done, key=lambda r: r.rid)
    gen_tokens = sum(len(r.generated) for r in done)
    ttft = sorted((r.first_token_at - r.submitted_at) for r in done)
    out = {
        "wall_s": wall_s,
        "goodput_tok_s": gen_tokens / wall_s,
        "ttft_p50_ms": ttft[len(ttft) // 2] * 1e3,
        "ttft_p99_ms": ttft[min(int(len(ttft) * 0.99),
                                len(ttft) - 1)] * 1e3,
        "prefill_tokens_total": eng.prefill_tokens_total,
        "prefill_tokens_avoided": eng.prefill_tokens_avoided,
        "migration_stall_s": eng.migration_stall_s,
        "migration_hidden_s": eng.migration_hidden_s,
        "migration_exposed_s": eng.migration_exposed_s,
        "moved_bytes": int(moved),
        "decode_traces": eng.decode_traces,
    }
    if share:
        idx = eng.prefix_index
        out["prefix"] = {"hits": idx.hits, "misses": idx.misses,
                         "cow_copies": idx.cow_copies,
                         "evictions": idx.evictions,
                         "allocated_pages": idx.allocated_pages()}
    return out, [r.generated for r in done]


def measure(smoke: bool = False, device: DeviceLike = None, params=None
            ) -> dict:
    """The four modes on starcoder2-3b ``.tiny()`` with the correctness
    asserts (equal tokens across modes, prefill tokens avoided); the
    full-size acceptance gates are :func:`check`'s.  ``params`` defaults
    to ``module.init(cfg, 0)`` on ``device``."""
    device = resolve_device(device)
    p = SMOKE if smoke else FULL
    arch = registry.get(ARCH).tiny()
    cfg = arch.cfg
    if params is None:
        params = arch.module.init(cfg, 0, device=device)
    prompts, arrive = _workload(cfg, p)
    payload = {"config": {"arch": ARCH, "page_t": PAGE_T, "smoke": smoke,
                          **p, "n_requests": len(prompts)},
               "modes": {}}
    tokens = {}
    for mode in MODES:
        payload["modes"][mode], tokens[mode] = _run_mode(
            mode, cfg, params, p, prompts, arrive, device)

    m = payload["modes"]
    # zero correctness drift: every mode generates identical tokens per
    # request — sharing, CoW, and unfenced migration are all invariant
    for mode in ("sharing", "sync", "overlap"):
        assert tokens[mode] == tokens["nosharing"], \
            f"token drift in mode {mode!r}"
    assert m["sharing"]["prefill_tokens_avoided"] > 0
    reduction = (m["sharing"]["prefill_tokens_avoided"]
                 / max(m["sharing"]["prefill_tokens_total"], 1))
    speedup = (m["sharing"]["goodput_tok_s"]
               / m["nosharing"]["goodput_tok_s"])
    payload["prefill_token_reduction"] = reduction
    payload["sharing_goodput_speedup"] = speedup
    stall_ratio = (m["overlap"]["migration_stall_s"]
                   / max(m["sync"]["migration_stall_s"], 1e-12))
    payload["overlap_stall_ratio"] = stall_ratio
    return payload


def check(payload: dict) -> None:
    """The reference's acceptance gates on a :func:`measure` result (full
    size; smoke sizes are noise-bound)."""
    m = payload["modes"]
    speedup = payload["sharing_goodput_speedup"]
    reduction = payload["prefill_token_reduction"]
    if not payload["config"]["smoke"]:
        # acceptance bars (full size; smoke sizes are noise-bound)
        assert speedup >= 1.5, f"goodput speedup {speedup:.2f}x < 1.5x"
        assert reduction >= 0.30, f"prefill reduction {reduction:.0%} < 30%"
        assert (m["overlap"]["migration_stall_s"]
                < m["sync"]["migration_stall_s"]), \
            (m["overlap"]["migration_stall_s"],
             m["sync"]["migration_stall_s"])
        assert m["overlap"]["migration_hidden_s"] > 0
        # hiding migrations must show up end-to-end, not just in the
        # stall split: unfenced churn serves at least sync's goodput
        assert (m["overlap"]["goodput_tok_s"]
                >= m["sync"]["goodput_tok_s"]), \
            (m["overlap"]["goodput_tok_s"], m["sync"]["goodput_tok_s"])


def csv_rows(payload: dict) -> list[str]:
    m = payload["modes"]
    speedup = payload["sharing_goodput_speedup"]
    reduction = payload["prefill_token_reduction"]
    return [
        f"serving/goodput,0,sharing=x{speedup:.2f};"
        f"prefill_avoided={reduction:.0%};"
        f"cow={m['sharing']['prefix']['cow_copies']}",
        f"serving/ttft,0,p50_base={m['nosharing']['ttft_p50_ms']:.0f}ms;"
        f"p50_shared={m['sharing']['ttft_p50_ms']:.0f}ms;"
        f"p99_shared={m['sharing']['ttft_p99_ms']:.0f}ms",
        f"serving/overlap,0,stall_sync={m['sync']['migration_stall_s']*1e3:.1f}ms;"
        f"stall_overlap={m['overlap']['migration_stall_s']*1e3:.1f}ms;"
        f"hidden={m['overlap']['migration_hidden_s']*1e3:.3f}ms",
    ]


def run(smoke: bool = False, device: DeviceLike = None, params=None
        ) -> tuple[list[str], dict]:
    payload = measure(smoke, device, params)
    check(payload)
    return csv_rows(payload), payload


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (asserts sharing correctness only)")
    ap.add_argument("--out", default="BENCH_serving_torch.json")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows, payload = run(smoke=args.smoke, device=args.device)
    for r in rows:
        print(r)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"serving/json,0,wrote={args.out}")


if __name__ == "__main__":
    main()
