"""Training driver: data pipeline -> loss and gradients -> AdamW (tiered
through the slow tier when the planner spills) -> checkpoints.

Runs every model family on the card (the default) or, when told
``--device cpu``, on the CPU.  Composes the deterministic pipeline, AdamW
or :class:`~repro_torch.optim.offload.TieredAdamW` (its pages moved by
``stream_copy``), async checkpointing, straggler mitigation, and the
Caption hook that walks the optimizer state's slow share.

Usage (on the card, starcoder2-3b at full size with a quarter of the
optimizer state paged through pinned host memory):
  python -m repro_torch.launch.train --arch starcoder2-3b --steps 20 \\
      --offload-fraction 0.25
On the CPU, with a reduced model:
  python -m repro_torch.launch.train --arch starcoder2-3b --tiny \\
      --device cpu --steps 16 --batch 2 --seq 16

Divergences from the reference: ``--devices`` defaults to ``h100`` and
``--device`` to ``cuda``; ``main`` takes ``params=`` (a parameter module
to start from) and ``cfg=`` (a config to train in place of ``--arch``'s,
of the same family); the default checkpoint
directory is under the temporary directory; a straggler's re-dispatch of
the fused step (which updates in place) waits for the first dispatch's
result instead of applying the step twice.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import threading
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import tiers as tiers_mod
from repro_torch.core.arbiter import CaptionArbiter, budgeted_config
from repro_torch.core.caption import CaptionConfig, CaptionController
from repro_torch.core.classifier import AccessProfile
from repro_torch.core.planner import BufferReq, plan as plan_placement
from repro_torch.core.policy import BufferClass
from repro_torch.core.telemetry import EpochWindow
from repro_torch.core.warmstart import WarmStartMemo
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.registry import get as get_arch
from repro_torch.optim import adamw, offload, schedules
from repro_torch.runtime.straggler import StragglerMitigator
from repro_torch.tree import named_leaves

def plan_optimizer(n_params: int, topo, slow_budget: float = 0.0):
    """(plan, slow fraction, per-slow-device weights or None) of the
    optimizer state (12 B a parameter) on ``topo``: if the plan spills,
    the driver uses the tiered optimizer.  With an arbiter budget the plan
    is reconciled with it up front."""
    opt_bytes = n_params * 12
    req = BufferReq(
        "opt_state", BufferClass.OPT_STATE, opt_bytes,
        AccessProfile(opt_bytes, opt_bytes, dependent_chain=1,
                      parallelism=1024, granularity=4 << 20,
                      compute_seconds=0.1),
    )
    placement = plan_placement(
        [req], topo, compute_seconds=0.1,
        reserve_fast_bytes=int(2 * n_params + 4 * n_params),
        write_budget_bw=slow_budget if slow_budget > 0 else None)
    dfr = placement.decisions["opt_state"].device_fractions
    slow_weights = None
    if topo.n_slow > 1 and dfr:
        slow_weights = [dfr.get(n, 0.0) for n in topo.slow_names]
    return placement, placement.slow_fraction("opt_state"), slow_weights


def build(arch_id: str, *, tiny: bool, batch: int, seq: int, lr: float,
          total_steps: int, offload_fraction: float | None = None,
          devices: str = "h100", slow_budget: float = 0.0, device=None,
          params=None, cfg=None):
    arch = get_arch(arch_id)
    if tiny:
        arch = arch.tiny()
    if cfg is not None:
        if cfg.family != arch.cfg.family:
            raise ValueError(f"cfg is a {cfg.family!r} model, {arch_id} "
                             f"a {arch.cfg.family!r} one")
        arch = dataclasses.replace(arch, cfg=cfg)
    cfg = arch.cfg
    device = resolve_device(device)
    opt_cfg = adamw.AdamWConfig(
        lr=lr, schedule=schedules.warmup_cosine(min(100, total_steps // 10),
                                                total_steps))
    if params is None:
        params = arch.module.init(cfg, 0, device=device)
    n_params = sum(x.numel() for _, x in named_leaves(params))
    topo = tiers_mod.topology_from_spec(devices)
    placement = None
    slow_weights = None
    if offload_fraction is None:
        placement, offload_fraction, slow_weights = plan_optimizer(
            n_params, topo, slow_budget)
    if offload_fraction > 0:
        opt = offload.TieredAdamW(
            opt_cfg, slow_fraction=offload_fraction,
            slow_weights=slow_weights,
            slow_device_names=topo.slow_names if topo.n_slow > 1 else None)
        opt_state = opt.init(params)
    else:
        opt = None
        opt_state = adamw.init_state(params)
    return arch, opt_cfg, opt, params, opt_state, n_params, placement, topo


def once(fn):
    """``fn`` run at most once: a second dispatch (the straggler's backup)
    waits for the first and returns its result."""
    lock, box = threading.Lock(), {}

    def run():
        with lock:
            if "out" not in box:
                box["out"] = fn()
        return box["out"]
    return run


def main(argv=None, *, params=None, cfg=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--offload-fraction", type=float, default=None)
    ap.add_argument("--devices", default="h100",
                    help="tier topology: a preset (h100, tpu-v5e, paper, "
                         "paper3) or a '+'-joined device list, fast tier "
                         "first (e.g. ddr5-l8+cxl-a+cxl-b)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--caption", action="store_true",
                    help="dynamic re-tiering of opt-state between steps")
    ap.add_argument("--caption-epoch-steps", type=int, default=8)
    ap.add_argument("--slow-budget", type=float, default=0.0,
                    help="aggregate slow-tier write budget in bytes/s for "
                         "the CaptionArbiter (0 = slow tier's nt-store bw)")
    ap.add_argument("--memo-path", default=None,
                    help="JSON warm-start memo: a recurring workload seeds "
                         "Caption at its remembered converged weights")
    ap.add_argument("--duels", type=int, default=0,
                    help="paired probe duels per Caption candidate point "
                         "(noise-robust probing); 0 = single-sample")
    ap.add_argument("--device", default="cuda",
                    help="where training runs: 'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch, opt_cfg, opt, params, opt_state, n_params, placement, topo = build(
        args.arch, tiny=args.tiny, batch=args.batch, seq=args.seq,
        lr=args.lr, total_steps=args.steps,
        offload_fraction=args.offload_fraction, devices=args.devices,
        slow_budget=args.slow_budget, device=device, params=params, cfg=cfg)
    cfg, mod = arch.cfg, arch.module
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"tiered_opt={'on' if opt else 'off'}")

    caption = None
    caption_window = None
    arbiter = None
    memo = None
    if args.caption and opt is not None:
        ccfg = CaptionConfig(epoch_steps=args.caption_epoch_steps,
                             duel_count=args.duels)
        if placement is not None:
            caption = CaptionController.from_plan(
                placement, "opt_state", topo, ccfg)
        else:
            caption = CaptionController(
                topo, ccfg, initial_fraction=opt.slow_fraction)
        arbiter = CaptionArbiter(topo, budgeted_config(topo, args.slow_budget))
        arbiter.register("opt_state", caption)
        caption_window = EpochWindow(opt.telemetry)
        if args.memo_path:
            memo = WarmStartMemo.load(args.memo_path)
            caption.attach_memo(memo)

    data = TokenPipeline(DataConfig(
        vocab=cfg.vocab_padded, batch=args.batch, seq=args.seq, seed=17))
    param_dtype = named_leaves(params)[0][1].dtype

    def make_batch(raw: dict) -> dict:
        b = {k: torch.as_tensor(v).to(device) for k, v in raw.items()}
        if cfg.family == "vlm":
            b["prefix_embeds"] = torch.zeros(
                (args.batch, cfg.vision.n_prefix_tokens, cfg.d_model),
                device=device)
        if cfg.family == "audio":
            # the reference's stub frames: the same draws every step
            rng = np.random.default_rng(0)
            b["frames"] = torch.as_tensor(rng.normal(
                size=(args.batch, cfg.encoder.n_ctx, cfg.d_model)),
                dtype=torch.float32).to(device=device, dtype=param_dtype)
        return b

    def fused_step(batch):
        loss, grads = mod.loss_and_grad(cfg, params, batch, remat=True)
        _, state, metrics = adamw.apply(opt_cfg, params, grads, opt_state)
        return state, dict(metrics, loss=loss)

    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start, (params, opt_state), meta = ckpt.restore((params, opt_state))
        print(f"resumed from step {start}")

    strag = StragglerMitigator()
    losses = []
    t0 = time.perf_counter()
    for step, raw in zip(range(start, args.steps), data.iter_from(start)):
        batch = make_batch(raw)
        if opt is None:
            opt_state, metrics = strag.run(once(lambda: fused_step(batch)))
        else:
            loss, grads = mod.loss_and_grad(cfg, params, batch, remat=True)
            params, opt_state, m2 = opt.step(params, grads, opt_state)
            del grads
            metrics = dict(m2, loss=loss)
            if caption is not None and (step + 1) % caption.cfg.epoch_steps == 0:
                # Caption epoch: modeled step time on the target tiers is
                # the throughput signal; the window supplies write share
                # and writer concurrency from the optimizer's route
                # counters.
                slow_b = opt.traffic_per_step_bytes(opt_state)
                agg_nt_bw = sum(t.nt_store_bw for t in topo.slows)
                slow_s = slow_b / agg_nt_bw if agg_nt_bw else 0.0
                modeled = max(0.1, slow_s)  # compute floor from the plan
                fast_resident = (12 * n_params * (1 - caption.fraction)
                                 + 6 * n_params)  # opt state + params/grads
                decision = arbiter.observe_window(
                    "opt_state", caption_window, 1.0 / modeled,
                    mover=opt.mover,
                    fast_pressure=min(
                        1.0, fast_resident / topo.fast.capacity_bytes),
                    slow_name=(None if opt.mover is not None
                               else (topo.slow_names if topo.n_slow > 1
                                     else "host")))
                if decision.changed:
                    if topo.n_slow > 1 and len(decision.weights) > 1:
                        opt_state = opt.repartition_weights(
                            params, opt_state, decision.weights)
                        caption.actuated_weights(
                            opt.achieved_weights(params, opt_state))
                    else:
                        opt_state = opt.repartition(
                            params, opt_state, decision.fraction)
                        caption.actuated(sum(
                            opt.achieved_weights(params, opt_state)))
                    print(f"caption: slow_fraction -> "
                          f"{decision.fraction:.2f} ({decision.reason})")
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            dt = (time.perf_counter() - t0) / args.log_every
            print(f"step {step+1:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f} ms/step")
            t0 = time.perf_counter()
        if (step + 1) % args.ckpt_every == 0 and opt is None:
            ckpt.save(step + 1, (params, opt_state), metadata={"arch": cfg.name})
    ckpt.wait()
    strag.close()
    if memo is not None:
        memo.save(args.memo_path)
        print(f"warmstart: entries={len(memo)} hits={memo.hits} "
              f"misses={memo.misses} -> {args.memo_path}")
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
          f"redispatched={strag.stats.redispatched}")
    return losses


if __name__ == "__main__":
    main()
