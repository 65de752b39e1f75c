"""Training steps of a DeepSeek-V2 decoder (latent attention, a held share
of each MoE layer's experts) through the port's training driver, as
``train_step`` runs a dense decoder's.

Set-up draws the leaves of ``reference/mla_moe_decoder.leaves`` on the
device from the seed, nests them into ``moe.MoEParams`` and hands them to
``launch.train.build`` with the configuration file's sizes.  The checked
steps, the window (each loss read some steps late), the step itself
(``loss_and_grad(..., remat=True)``, then ``adamw.apply`` or
``TieredAdamW.step``) and the readings are ``train_step``'s.  One thing
is added: each step's forward adds the held experts' pair histogram to a
float32 tensor on the device (``moe.loss``'s ``expert_counts``), zeroed
as a window opens and read once after the timed window, never inside a
step."""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from cxlbench import weights
from cxlbench.common import synchronize
from cxlbench.drivers import train_step
from cxlbench.drivers.train_step import (  # noqa: F401
    AHEAD_SECONDS, KEYS, _first_grads, _moments_and_masters, _nest,
    end_to_end, release, step)
from cxlbench.reference import dense_decoder
from cxlbench.reference import mla_moe_decoder as ref


def arch_config(config: dict):
    """The port's configuration for a configuration file: the registry's
    entry for ``arch`` with the file's sizes, the router over the
    published experts, ``n_routed_experts`` of them held from
    ``first_held_expert``."""
    from repro_torch.configs.base import MLASpec, YarnSpec
    from repro_torch.configs.deepseek_v2_lite import held_share
    from repro_torch.models.registry import get_config
    c, rs = config, config["rope_scaling"]
    fixed = {"hidden_act": "silu", "rms_norm_eps": 1e-6, "q_lora_rank": None,
             "scoring_func": "softmax", "topk_method": "greedy",
             "n_group": 1, "topk_group": 1, "routed_scaling_factor": 1,
             "moe_layer_freq": 1, "attention_bias": False, "seq_aux": True}
    for key, want in fixed.items():
        if c[key] != want:
            raise ValueError(f"the port runs {key} = {want!r} only, "
                             f"not {c[key]!r}")
    if rs["type"] != "yarn":
        raise ValueError("the port's latent attention scales by YaRN only")
    base = get_config(c["arch"])
    moe = dataclasses.replace(
        base.moe, n_experts=c["published"]["n_routed_experts"],
        top_k=c["num_experts_per_tok"], expert_d_ff=c["moe_intermediate_size"],
        n_shared=c["n_shared_experts"],
        shared_d_ff=c["moe_intermediate_size"],
        first_dense=c["first_k_dense_replace"],
        norm_topk=c["norm_topk_prob"], seq_aux_alpha=c["aux_loss_alpha"])
    return held_share(dataclasses.replace(
        base, n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c["v_head_dim"],
        d_ff=c["intermediate_size"], vocab=c["vocab_size"],
        rope_theta=c["rope_theta"], tie_embeddings=c["tie_word_embeddings"],
        max_seq=c["max_position_embeddings"], param_dtype=c["torch_dtype"],
        moe=moe,
        mla=MLASpec(kv_lora_rank=c["kv_lora_rank"],
                    qk_nope_head_dim=c["qk_nope_head_dim"],
                    qk_rope_head_dim=c["qk_rope_head_dim"],
                    v_head_dim=c["v_head_dim"]),
        yarn=YarnSpec(factor=rs["factor"],
                      original_max_position=rs[
                          "original_max_position_embeddings"],
                      beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
                      mscale=rs["mscale"],
                      mscale_all_dim=rs["mscale_all_dim"])),
        c["n_routed_experts"], c["first_held_expert"])


class Counting:
    """The MoE family's ``loss_and_grad``, each forward adding its batch's
    held-expert histogram to ``counts`` on the device."""

    def __init__(self, module, counts: torch.Tensor):
        self.module, self.counts = module, counts

    def loss_and_grad(self, cfg, params, batch, **kw):
        return self.module.loss_and_grad(cfg, params, batch,
                                         expert_counts=self.counts, **kw)


def setup(run) -> None:
    from repro_torch.launch import train
    from repro_torch.models.moe import MoEParams
    cfg, tr, dev = run.config, run.traffic, run.device
    acfg = arch_config(cfg)
    if acfg.vocab_padded != cfg["vocab_size"]:
        raise ValueError("the vocabulary must be a multiple of 128")
    tree = _nest({leaf.name: weights.make_leaf(leaf, i, run.seed, dev)
                  for i, leaf in enumerate(ref.leaves(cfg))})
    params = MoEParams(tree["embed"], tree["head_dense"], tree["units"],
                       tree["final_norm"], tree["lm_head"])
    del tree
    arch, opt_cfg, opt, params, opt_state, _, _, _ = train.build(
        cfg["arch"], tiny=False, batch=tr["batch"], seq=tr["seq"],
        lr=tr["lr"], total_steps=tr["total_steps"],
        offload_fraction=float(tr["slow_fraction"]), device=dev,
        params=params, cfg=acfg)
    run.note("weights made, optimizer built")
    counts = torch.zeros(cfg["n_routed_experts"], dtype=torch.float32,
                         device=dev)
    run.state = {"mod": Counting(arch.module, counts), "cfg": acfg,
                 "opt_cfg": opt_cfg, "opt": opt, "params": params,
                 "opt_state": opt_state, "step": 0, "held_counts": counts}
    got = {"losses": []}
    for s in range(int(tr["checked_steps"])):
        t0 = time.perf_counter()
        got["losses"].append(float(step(run)))
        step_s = time.perf_counter() - t0
        if s == 0:
            got["first_grads"] = _first_grads(run)
    run.state["lag"] = max(1, math.ceil(AHEAD_SECONDS / step_s))
    run.note(f"checked steps run, the window reads losses "
             f"{run.state['lag']} steps late")
    got["change_norms"] = _change_norms(run)
    run.state["readings"] = got
    synchronize(dev)


def _change_norms(run) -> dict:
    synchronize(run.device)
    _, master = _moments_and_masters(run)
    out = {}
    for i, leaf in enumerate(ref.leaves(run.config)):
        start = weights.make_leaf(leaf, i, run.seed, run.device)
        out[leaf.name] = math.sqrt(dense_decoder.gap_sq_norm(
            master[leaf.name], start))
        del start
    return out


def window(run, seconds: float) -> dict:
    """``train_step``'s window, with the held experts' histogram of its
    steps (on the device, read by :func:`facts`)."""
    counts = run.state["held_counts"]
    counts.zero_()
    out = train_step.window(run, seconds)
    out["held_counts"] = counts.clone()
    return out


def facts(run) -> None:
    """The timed window's pairs a held expert, read once it has closed."""
    run.facts["held_load"] = run.timed["held_counts"].tolist()


def check(run) -> list:
    """``(name, value, limit)`` of the checked steps against the
    reference's."""
    got = run.state["readings"]
    want = ref.train_readings(run.config, run.traffic, run.seed, run.device,
                              against=got.pop("first_grads"))
    gaps = dense_decoder.compare(got, want)
    limits = run.config["limits"]
    return [(k, v, float(limits[k])) for k, v in gaps.items()]
