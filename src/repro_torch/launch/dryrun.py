"""Dry run on one card: trace every (arch x shape) cell on fake tensors.

For each cell this records, without allocating any model-scale tensor:
  * parameter, optimizer-state, batch and cache bytes, exact from the
    abstract trees (``steps.input_specs``, under ``FakeTensorMode``);
  * the step's FLOPs and eager HBM bytes (``hlo_analysis.costs_of``), and
    the most storage its trace held at once beyond its arguments;
  * ``peak_per_device`` (arguments + that peak) against the card's
    memory (``fits_hbm``);
  * the reference's ``model_flops`` and, when the planner offloads the
    optimizer state, the host tier's bytes.

Where the reference lowers and compiles for a TPU pod, the port traces:
the step runs on ``cpu`` fake tensors, so every kernel wrapper takes its
plain version and the counts are the plain versions' work (a fake tensor
on the card would reach a kernel launch).  The mesh reduces to one card
(1 x 1), against its memory (``hbm_bytes``, by default the card's).

Loop trips, as the reference's analyzer corrects for a scanned body: a
train cell traces one micro-batch's gradients and multiplies by
``n_micro``, then the update once.  A prefill cell is traced at one and
at two of the model's repeated units (:func:`depth_units`) and
extrapolated linearly to its depth: its units are identical and an
inference step frees each unit's activations, so FLOPs, bytes and the
peak are linear in the depth (a training step's peak is not: the
gradients of every layer meet at the end of the backward, so train and
decode cells are traced whole).  Argument bytes come from the
full-depth trees.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--workers 8]
      [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from typing import Callable, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.caption import CaptionConfig
from repro_torch.launch import shardings as shmod, steps as steps_mod
from repro_torch.launch.hlo_analysis import HloCosts, costs_of
from repro_torch.launch.mesh import chips as mesh_chips, dp_size, make_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.models.registry import ARCH_IDS, get as get_arch
from repro_torch.optim import adamw
from repro_torch.tree import named_leaves

#: the one card every cell is traced for
CARD_MESH = make_mesh((1, 1), ("data", "model"))
MESH_TAG = "h100x1"
DEFAULT_OUT = "experiments/dryrun_torch"
# Offload optimizer state when (moments+master) would eat >35% of HBM.
OFFLOAD_BYTES_FRAC = 0.35


def should_offload_opt(cfg: ArchConfig, n_chips: int,
                       hbm_bytes: Optional[int] = None) -> bool:
    hbm = shmod.default_hbm_bytes() if hbm_bytes is None else hbm_bytes
    opt_bytes = cfg.param_count() * 12  # fp32 mu+nu+master
    return opt_bytes / n_chips > OFFLOAD_BYTES_FRAC * hbm


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.batch * shape.seq
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.batch * shape.seq
    return 2.0 * n_active * shape.batch  # decode: one token per sequence


def depth_units(cfg: ArchConfig) -> tuple[int, Callable[[int], ArchConfig]]:
    """(the model's count of repeated units, a config of ``d`` units): a
    unit is a layer; a MoE unit (``every`` layers after the
    ``first_dense`` ones); a block pattern (the tail layers stay); or an
    encoder layer and a decoder layer."""
    if cfg.family == "moe":
        spec = cfg.moe
        return ((cfg.n_layers - spec.first_dense) // spec.every,
                lambda d: dataclasses.replace(
                    cfg, n_layers=spec.first_dense + d * spec.every))
    if cfg.block_pattern:
        unit = len(cfg.block_pattern)
        tail = cfg.n_layers % unit
        return (cfg.n_layers // unit, lambda d: dataclasses.replace(
            cfg, n_layers=d * unit + tail))
    if cfg.encoder is not None:
        if cfg.encoder.n_layers != cfg.n_layers:
            raise ValueError("encoder and decoder depths differ")
        return (cfg.n_layers, lambda d: dataclasses.replace(
            cfg, n_layers=d, encoder=dataclasses.replace(cfg.encoder,
                                                         n_layers=d)))
    return cfg.n_layers, lambda d: dataclasses.replace(cfg, n_layers=d)


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in named_leaves(tree))


def _sum(a: HloCosts, times: int, b: HloCosts) -> HloCosts:
    """``times`` runs of ``a``, then ``b`` once."""
    return HloCosts(flops=a.flops * times + b.flops,
                    hbm_bytes=a.hbm_bytes * times + b.hbm_bytes,
                    collectives=[], n_devices=1,
                    peak_bytes=max(a.peak_bytes, b.peak_bytes))


def _extrapolate(one: HloCosts, two: HloCosts, units: int) -> HloCosts:
    """The costs at ``units`` units from those at one and at two."""
    def at(a: float, b: float) -> float:
        return a + (units - 1) * (b - a)
    return HloCosts(flops=at(one.flops, two.flops),
                    hbm_bytes=at(one.hbm_bytes, two.hbm_bytes),
                    collectives=[], n_devices=1,
                    peak_bytes=at(one.peak_bytes, two.peak_bytes))


def step_costs(arch, shape: ShapeSpec, scfg, act_policy: dict,
               n_micro: int, offload: bool, hbm: int,
               cache_dtype=None) -> HloCosts:
    """The traced costs of the cell's step for ``arch`` as configured
    (``cache_dtype``: the full model's, which a shallower one keeps)."""
    specs = steps_mod.input_specs(arch, shape, CARD_MESH, scfg,
                                  cache_dtype, hbm_bytes=hbm)
    p = specs.params
    if shape.kind == "prefill":
        return costs_of(steps_mod.make_prefill_step(
            arch, act_policy=act_policy), p, specs.batch)
    if shape.kind == "decode":
        return costs_of(steps_mod.make_serve_step(
            arch, act_policy=act_policy), p, specs.cache, specs.tokens)
    micro = steps_mod.micro_batches(specs.batch, n_micro)[0]
    if offload:
        return costs_of(steps_mod.make_micro_grad_step(
            arch, act_policy=act_policy), p, micro)
    opt_cfg = adamw.AdamWConfig()
    if n_micro == 1:
        return costs_of(steps_mod.make_train_step(
            arch, opt_cfg, act_policy=act_policy), p, specs.opt_state,
            specs.batch)
    with specs.mode:
        acc = steps_mod.zero_accumulators(p)
    grads = costs_of(lambda p_, a_, mb: steps_mod.accumulate(
        arch, p_, a_, mb, act_policy=act_policy), p, acc, micro)
    update = costs_of(lambda p_, o_, a_: adamw.apply(
        opt_cfg, p_, {k: g.mul_(1.0 / n_micro) for k, g in a_.items()}, o_),
        p, specs.opt_state, acc)
    return _sum(grads, n_micro, update)


def lower_cell(arch_id: str, shape: ShapeSpec, *, n_micro: int = 0,
               zero1: bool = False, wkv_chunked: bool = True,
               flash: bool = True, hbm_bytes: Optional[int] = None,
               offload: Optional[bool] = None) -> dict:
    """Trace one cell on one card; returns its record.  ``offload``
    (default: :func:`should_offload_opt`) picks the train cell's program:
    the fused step, or the micro-step of a tiered optimizer.  ``zero1``
    changes only the specs, which one card does not apply: no FLOP, byte
    or peak of the record moves with it."""
    arch = get_arch(arch_id)
    cfg = arch.cfg
    mesh = CARD_MESH
    hbm = shmod.default_hbm_bytes() if hbm_bytes is None else hbm_bytes
    scfg = shmod.ShardingConfig.for_arch(cfg, hbm)
    if zero1:
        scfg = dataclasses.replace(scfg, fsdp=False, zero1=True)
    t0 = time.time()
    specs = steps_mod.input_specs(arch, shape, mesh, scfg, hbm_bytes=hbm)
    act_policy = shmod.activation_policy(mesh, seq_sharded=(
        shape.kind == "prefill" and shape.batch < dp_size(mesh)))
    if wkv_chunked:
        act_policy["_wkv_chunked"] = True
    if not flash:
        act_policy.pop("_flash", None)
    if n_micro <= 0 and shape.kind == "train":
        # default: per-device microbatch of 1 sequence
        n_micro = max(1, shape.batch // dp_size(mesh))
    if offload is None:
        offload = shape.kind == "train" and should_offload_opt(
            cfg, mesh_chips(mesh), hbm)
    record = {
        "arch": arch_id, "shape": shape.name, "kind": shape.kind,
        "mesh": dict(mesh.shape), "chips": mesh_chips(mesh),
        "fsdp": scfg.fsdp, "n_micro": n_micro if shape.kind == "train" else 0,
        "offload_opt": offload, "model_flops_total": model_flops(cfg, shape),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "zero1": zero1, "wkv_chunked": wkv_chunked, "flash": flash,
        "hbm_bytes": hbm,
    }
    sizes = {"params": tree_bytes(specs.params)}
    for name in ("batch", "opt_state", "cache", "tokens"):
        value = getattr(specs, name)
        if value is not None:
            sizes[name] = tree_bytes(value)
    record["bytes"] = sizes
    record["cache_dtype"] = str(specs.cache_dtype).split(".")[-1] \
        if specs.cache is not None else None

    units, cfg_at = depth_units(cfg)
    if shape.kind != "prefill" or units <= 2:
        costs = step_costs(arch, shape, scfg, act_policy, n_micro, offload,
                           hbm, specs.cache_dtype)
        record["depths_traced"] = [units]
    else:
        one, two = (step_costs(dataclasses.replace(arch, cfg=cfg_at(d)),
                               shape, scfg, act_policy, n_micro, offload,
                               hbm, specs.cache_dtype) for d in (1, 2))
        costs = _extrapolate(one, two, units)
        record["depths_traced"] = [1, 2]
    record["units"] = units
    args = sizes["params"]
    if shape.kind == "train" and offload:
        # the device program of a tiered optimizer: ONE micro-batch's
        # bf16 gradients, run n_micro times a step (the roofline
        # aggregates); moments and master live on the host
        args += sizes["batch"] // n_micro
        record["offload_micro_step"] = True
        opt_bytes = cfg.param_count() * 12
        record["offload_host_bytes_per_host"] = opt_bytes
        record["offload_traffic_bytes_per_step_per_chip"] = (
            cfg.param_count() * (12 + 12 + 2) / mesh_chips(mesh))
        ccfg = CaptionConfig()
        record["migration_bytes_per_step_per_chip"] = (
            opt_bytes * ccfg.step
            / (ccfg.epoch_steps * ccfg.probe_epochs) / mesh_chips(mesh))
    elif shape.kind == "train":
        args += sizes["opt_state"] + sizes["batch"]
        if n_micro > 1:  # the fp32 gradient accumulators
            args += 4 * sum(t.numel() for _, t in named_leaves(specs.params))
    elif shape.kind == "prefill":
        args += sizes["batch"]
    else:
        args += sizes["cache"] + sizes["tokens"]
    record["trace_s"] = round(time.time() - t0, 2)
    peak = args + costs.peak_bytes
    record["memory"] = {"argument_bytes": int(args),
                        "activation_peak_bytes": int(costs.peak_bytes),
                        "peak_per_device": int(peak)}
    record["fits_hbm"] = peak <= hbm
    record["hlo"] = {
        "flops_per_device": costs.flops,
        "hbm_bytes_per_device": costs.hbm_bytes,
        "collective_counts": costs.collective_counts(),
        "ici_bytes_per_device": costs.collective_bytes("ici"),
        "dcn_bytes_per_device": costs.collective_bytes("dcn"),
    }
    return record


def run_cell(arch_id: str, shape_name: str, out_dir: str, **kw) -> dict:
    shape = SHAPES[shape_name]
    cfg = get_arch(arch_id).cfg
    ok, why = applicable(cfg, shape)
    name = f"{arch_id}__{shape_name}__{MESH_TAG}"
    if not ok:
        record = {"arch": arch_id, "shape": shape_name, "skipped": why,
                  "mesh": MESH_TAG}
        print(f"SKIP {name}: {why}", flush=True)
    else:
        try:
            record = lower_cell(arch_id, shape, **kw)
            mem = record["memory"]
            print(f"OK   {name}: trace={record['trace_s']}s "
                  f"peak={mem['peak_per_device'] / 2**30:.2f}GiB "
                  f"fits={record['fits_hbm']} "
                  f"flops/dev={record['hlo']['flops_per_device']:.3e} "
                  f"bytes/dev={record['hlo']['hbm_bytes_per_device']:.3e}",
                  flush=True)
        except Exception as e:  # a cell's failure is recorded, the sweep goes on
            record = {"arch": arch_id, "shape": shape_name, "mesh": MESH_TAG,
                      "error": f"{type(e).__name__}: {e}",
                      "traceback": traceback.format_exc()[-2000:]}
            print(f"FAIL {name}: {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(record, f, indent=1, default=float)
    return record


def _run_one(job: tuple) -> dict:
    arch_id, shape_name, out_dir, kw = job
    return run_cell(arch_id, shape_name, out_dir, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--n-micro", type=int, default=0)
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--no-wkv-chunked", action="store_true")
    ap.add_argument("--no-flash", action="store_true")
    ap.add_argument("--workers", type=int, default=1,
                    help="cells traced at once, one process each")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    kw = {"n_micro": args.n_micro, "zero1": args.zero1,
          "wkv_chunked": not args.no_wkv_chunked, "flash": not args.no_flash,
          "hbm_bytes": shmod.default_hbm_bytes()}
    # the long traces first (training, then prefill), so the pool's
    # workers finish together
    jobs = sorted(((a, s, args.out, kw) for a in archs for s in shapes),
                  key=lambda job: list(SHAPES).index(job[1]))
    t0 = time.time()
    if args.workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.workers, maxtasksperchild=1) as pool:
            records = pool.map(_run_one, jobs, chunksize=1)
    else:
        records = [_run_one(job) for job in jobs]
    failures = sum("error" in rec for rec in records)
    print(f"\ndone; cells={len(records)} failures={failures} "
          f"seconds={time.time() - t0:.1f}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
