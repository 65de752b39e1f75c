"""Serving driver: batched engine over the tiered KV cache.

Usage (on the card, the default):
  python -m repro_torch.launch.serve --arch starcoder2-3b --requests 16 \
      --max-batch 16 --max-len 4096 --page-t 64 --caption
On the CPU, with a reduced model:
  python -m repro_torch.launch.serve --arch starcoder2-3b --tiny \
      --device cpu --requests 8 --slow-fraction 0.5
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.arbiter import CaptionArbiter, budgeted_config
from repro_torch.core.caption import CaptionConfig, CaptionController
from repro_torch.core.ledger import TierLedger
from repro_torch.core.mover import BulkMover
from repro_torch.core.policy import MemPolicy
from repro_torch.core.tiers import topology_from_spec
from repro_torch.core.warmstart import WarmStartMemo
from repro_torch.device import resolve_device
from repro_torch.models.registry import get as get_arch
from repro_torch.serving.engine import ServingEngine, kv_access_profile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--slow-fraction", type=float, default=0.0)
    ap.add_argument("--devices", default="h100",
                    help="tier topology: a preset (h100, tpu-v5e, paper, paper3) "
                         "or a '+'-joined device list, fast tier first "
                         "(e.g. ddr5-l8+cxl-a+cxl-b)")
    ap.add_argument("--page-t", type=int, default=16)
    ap.add_argument("--caption", action="store_true",
                    help="dynamic re-tiering of KV pages between decode steps")
    ap.add_argument("--caption-epoch-steps", type=int, default=8)
    ap.add_argument("--slow-budget", type=float, default=0.0,
                    help="aggregate slow-tier write budget in bytes/s for "
                         "the CaptionArbiter (0 = slow tier's nt-store bw)")
    ap.add_argument("--latency-every", type=int, default=0,
                    help="every Nth request is latency-SLO class (pins its "
                         "KV pages fast); 0 = all batch-class")
    ap.add_argument("--prefix-pages", type=int, default=0,
                    help="shared-prefix page pool size; repeated prompt "
                         "prefixes attach by reference instead of replaying")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="tokens of prompt prefix shared across requests "
                         "(0 = fully independent prompts)")
    ap.add_argument("--admission", choices=("none", "cost"), default="none",
                    help="'cost': defer batch-class admissions the perf "
                         "model predicts would pressure latency pins")
    ap.add_argument("--async-mover", action="store_true",
                    help="issue Caption migrations unfenced so they overlap "
                         "decode compute (drained at epoch boundaries)")
    ap.add_argument("--memo-path", default=None,
                    help="JSON warm-start memo: converged Caption weights "
                         "are filed under a workload fingerprint and a "
                         "recurring workload seeds at its remembered "
                         "optimum, skipping the walk")
    ap.add_argument("--duels", type=int, default=0,
                    help="paired probe duels per Caption candidate point "
                         "(noise-robust probing); 0 = single-sample")
    ap.add_argument("--ledger-report", action="store_true",
                    help="register the serving pools (KV + shared-prefix "
                         "pages) in a TierLedger and print the per-tier "
                         "capacity report after the run")
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_arch(args.arch)
    if args.tiny:
        arch = arch.tiny()
    cfg = arch.cfg
    if cfg.family not in ("dense", "vlm"):
        # The reference lists ``moe`` too, but its tiered decode step reads
        # a dense tree's ``layers`` and stops with a KeyError on a MoE
        # tree; the MoE family decodes through ``moe.decode_step``.
        raise SystemExit("tiered serving runs the dense and vlm families")
    params = arch.module.init(cfg, torch.Generator(device=device).manual_seed(0),
                              device=device)
    topology = topology_from_spec(args.devices)
    if topology.n_slow > 1:
        # Seed the per-device split bandwidth-proportionally (Fig. 10's
        # best static ratio); Caption tunes the vector from there.
        bw = topology.bandwidth_weights()
        policy = MemPolicy.from_tier_fractions(
            topology.fast.name, topology.slow_names,
            [args.slow_fraction * w for w in bw])
    else:
        policy = MemPolicy.from_slow_fraction("fast", "slow",
                                              args.slow_fraction)
    caption = None
    arbiter = None
    memo = None
    if args.caption:
        # §6.1 seeding: classify the KV cache's access profile against
        # the active slow pool — a latency-bound shape is fast-pinned
        # automatically (from_profile zeroes the prior and the floor).
        profile = kv_access_profile(cfg, args.max_batch, args.max_len,
                                    page_t=args.page_t)
        caption = CaptionController.from_profile(
            profile, topology,
            CaptionConfig(epoch_steps=args.caption_epoch_steps,
                          duel_count=args.duels),
            initial_fraction=args.slow_fraction)
        if args.memo_path:
            memo = WarmStartMemo.load(args.memo_path)
            caption.attach_memo(memo)
        # One arbiter owns the slow-tier write budget; the engine registers
        # its KV controller under it (more buffers would share the pool).
        arbiter = CaptionArbiter(topology,
                                 budgeted_config(topology, args.slow_budget))
    mover = (BulkMover(topology, asynchronous=True, device=device)
             if args.async_mover else None)
    ledger = TierLedger(topology) if args.ledger_report else None
    engine = ServingEngine(
        cfg, params, max_batch=args.max_batch, max_len=args.max_len,
        policy=policy, topology=topology, page_t=args.page_t,
        caption=caption, arbiter=arbiter, mover=mover,
        prefix_pages=args.prefix_pages, admission=args.admission,
        overlap=args.async_mover, ledger=ledger, device=device)
    rng = np.random.default_rng(0)
    shared = (rng.integers(0, cfg.vocab_padded,
                           size=args.shared_prefix).tolist()
              if args.shared_prefix else [])
    t0 = time.perf_counter()
    for i in range(args.requests):
        prompt = shared + rng.integers(0, cfg.vocab_padded, size=4).tolist()
        slo = ("latency" if args.latency_every
               and i % args.latency_every == 0 else "batch")
        engine.submit(prompt, max_new_tokens=args.new_tokens, slo=slo)
    done = engine.run_until_drained()
    wall = time.perf_counter() - t0
    if mover is not None:
        mover.close()
    lats = sorted(r.latency for r in done)
    modeled = sorted(r.modeled_seconds for r in done)
    p99 = lats[int(len(lats) * 0.99) - 1] if len(lats) > 1 else lats[0]
    print(f"completed={len(done)} wall={wall:.2f}s "
          f"p50={lats[len(lats)//2]*1e3:.1f}ms p99={p99*1e3:.1f}ms "
          f"modeled_p50={modeled[len(modeled)//2]*1e3:.3f}ms "
          f"slow_frac={engine.cache.slow_fraction():.2f}")
    if topology.n_slow > 1:
        fr = engine.cache.device_fractions()
        print("devices: " + " ".join(f"{k}={v:.2f}" for k, v in fr.items()))
    if caption is not None:
        traj = " -> ".join(f"{f:.2f}" for _, f in engine.caption_trace[-8:])
        print(f"caption: phase={caption.phase.value} trajectory {traj}")
    if memo is not None:
        memo.save(args.memo_path)
        print(f"warmstart: entries={len(memo)} hits={memo.hits} "
              f"misses={memo.misses} drift_misses={memo.drift_misses} "
              f"-> {args.memo_path}")
    if arbiter is not None:
        print(f"arbiter: budget={arbiter.cfg.slow_bw_budget:.3g} B/s "
              f"demand={arbiter.aggregate_demand_bw():.3g} B/s "
              f"grants={ {k: f'{v:.3g}' for k, v in arbiter.grants().items()} }")
    if args.prefix_pages:
        idx = engine.prefix_index
        print(f"prefix: hits={idx.hits} misses={idx.misses} "
              f"pages={idx.allocated_pages()} cow={idx.cow_copies} "
              f"evictions={idx.evictions} "
              f"prefill_avoided={engine.prefill_tokens_avoided}"
              f"/{engine.prefill_tokens_total}")
    if args.admission != "none":
        print(f"admission: deferrals={engine.admission_deferrals}")
    if args.async_mover:
        print(f"overlap: stall={engine.migration_stall_s*1e3:.1f}ms "
              f"hidden={engine.migration_hidden_s*1e3:.3f}ms "
              f"exposed={engine.migration_exposed_s*1e3:.3f}ms")
    if ledger is not None:
        engine.register_pools()
        print("ledger (framework-managed serving pools):")
        print(ledger.report())
    return done


if __name__ == "__main__":
    main()
