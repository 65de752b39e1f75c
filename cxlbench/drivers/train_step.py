"""Training steps of a dense decoder through the port's training driver.

Set-up: the weights are drawn on the device from the seed (a generator a
leaf) and handed to ``launch.train.build``, which makes the optimizer:
``TieredAdamW`` with the traffic's slow fraction, or fused AdamW when it
is 0.  The first ``checked_steps`` steps run through the window's own
step, on batches of their own; the readings the check needs are taken
between them (each leaf's first gradient from the optimizer's moments,
kept on the host; each leaf's change after the last, read from the state the next step
starts from: the pinned master of a paged leaf, else the parameter).

A step is ``train.main``'s loop body: ``loss_and_grad(..., remat=True)``,
then ``TieredAdamW.step`` or ``adamw.apply``, the loss read back as the
driver logs it.  The window reads each loss some steps late, so that
about :data:`AHEAD_SECONDS` of steps are dispatched ahead of the one it
waits for and a host stall (a collection, a shared core) finds the card
fed.  Spans mark the two calls and add no wait for the card: a traced
run's steps run as an untraced run's.  In the untraced stretch of a
traced run, CUDA events recorded before, between and after the two calls
time each on the device, read once the window has closed."""
from __future__ import annotations

import collections
import dataclasses
import gc
import math
import time

import torch

from cxlbench import traffic as traffic_mod
from cxlbench import weights
from cxlbench.common import synchronize
from cxlbench.reference import dense_decoder as ref

#: seconds of steps the window dispatches ahead of the step whose loss
#: it reads
AHEAD_SECONDS = 4.0

#: the traffic parameters this driver implements
KEYS = ("driver", "batch", "seq", "remat", "slow_fraction", "lr",
        "total_steps", "checked_steps", "trace_seconds")


def arch_config(config: dict):
    """The port's ``ArchConfig`` for a configuration file."""
    from repro_torch.models.registry import get_config
    acts = {"gelu_pytorch_tanh": "gelu"}
    norms = {"layer_norm": "layernorm"}
    if config["norm_epsilon"] != 1e-5:
        raise ValueError("the port's LayerNorm takes eps 1e-5 only")
    return dataclasses.replace(
        get_config(config["arch"]), n_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"], n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"], d_ff=config["intermediate_size"],
        vocab=config["vocab_size"], act=acts[config["hidden_act"]],
        norm=norms[config["norm_type"]], rope_theta=config["rope_theta"],
        qkv_bias=config["use_bias"] in ("qkv", True),
        tie_embeddings=config["tie_word_embeddings"],
        local_window=config["sliding_window"],
        param_dtype=config["torch_dtype"])


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, x in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = x
    return out


def setup(run) -> None:
    from repro_torch.launch import train
    from repro_torch.models.transformer import DenseParams
    cfg, tr, dev = run.config, run.traffic, run.device
    acfg = arch_config(cfg)
    if acfg.vocab_padded != cfg["vocab_size"]:
        raise ValueError("the vocabulary must be a multiple of 128")
    tree = _nest(weights.dense_weights(cfg, run.seed, dev))
    params = DenseParams(tree["embed"], tree["layers"], tree["final_norm"],
                         tree.get("lm_head"))
    del tree
    arch, opt_cfg, opt, params, opt_state, n_params, _, _ = train.build(
        cfg["arch"], tiny=False, batch=tr["batch"], seq=tr["seq"],
        lr=tr["lr"], total_steps=tr["total_steps"],
        offload_fraction=float(tr["slow_fraction"]), device=dev,
        params=params, cfg=acfg)
    run.note("weights made, optimizer built")
    run.state = {"mod": arch.module, "cfg": acfg, "opt_cfg": opt_cfg,
                 "opt": opt, "params": params, "opt_state": opt_state,
                 "step": 0}
    got = {"losses": []}
    for s in range(int(tr["checked_steps"])):
        t0 = time.perf_counter()
        got["losses"].append(float(step(run)))
        step_s = time.perf_counter() - t0
        if s == 0:
            got["first_grads"] = _first_grads(run)
    # the last checked step ran warm, from an idle card to its loss
    run.state["lag"] = max(1, math.ceil(AHEAD_SECONDS / step_s))
    run.note(f"checked steps run, the window reads losses "
             f"{run.state['lag']} steps late")
    got["change_norms"] = _change_norms(run)
    run.state["readings"] = got
    synchronize(dev)


def _moments_and_masters(run) -> tuple[dict, dict]:
    """({leaf: first moment}, {leaf: what the next step reads as the
    parameter}): pinned pages of a paged leaf, else the card's tensors."""
    from repro_torch.tree import named_leaves
    st, params = run.state["opt_state"], run.state["params"]
    if run.state["opt"] is None:
        return dict(st["mu"]), dict(named_leaves(params))
    mu, master = dict(st["fast"]["mu"]), dict(named_leaves(params))
    for k, leaf in st["slow"].items():
        mu[k] = leaf.mu[:leaf.size]
        master[k] = leaf.master[:leaf.size]
    return mu, master


def _first_grads(run) -> dict:
    """Each leaf's gradient as the optimizer got it in step 1, its first
    moment over ``1 - b1``, copied to the host in float32."""
    synchronize(run.device)
    mu, _ = _moments_and_masters(run)
    b1 = run.state["opt_cfg"].b1
    return {k: m.to("cpu", torch.float32, copy=True).div_(1 - b1)
            for k, m in mu.items()}


def _change_norms(run) -> dict:
    synchronize(run.device)
    _, master = _moments_and_masters(run)
    out = {}
    for i, leaf in enumerate(weights.dense_leaves(run.config)):
        start = weights.make_leaf(leaf, i, run.seed, run.device)
        out[leaf.name] = math.sqrt(ref.gap_sq_norm(master[leaf.name], start))
        del start
    return out


def step(run) -> torch.Tensor:
    """One training step on the next batch; returns the loss."""
    s, tr, cfg = run.state, run.traffic, run.state["cfg"]
    batch = traffic_mod.token_batch(run.seed, s["step"], batch=tr["batch"],
                                    seq=tr["seq"], vocab=cfg.vocab_padded,
                                    device=run.device)
    s["step"] += 1
    spans = run.spans
    events = s.get("events") if spans.enabled else None
    if events is not None:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
    with spans.span("fwd_bwd"):
        loss, grads = s["mod"].loss_and_grad(cfg, s["params"], batch,
                                             remat=tr["remat"])
    if events is not None:
        ev[1].record()
    with spans.span("opt_step"):
        if s["opt"] is None:
            from repro_torch.optim import adamw
            _, s["opt_state"], _ = adamw.apply(s["opt_cfg"], s["params"],
                                               grads, s["opt_state"])
        else:
            s["params"], s["opt_state"], _ = s["opt"].step(
                s["params"], grads, s["opt_state"])
        del grads
    if events is not None:
        ev[2].record()
        events.append(ev)
    return loss


def window(run, seconds: float) -> dict:
    """Steps for ``seconds``, each loss read ``lag`` steps late; once the
    time is up no step is sent, and the window closes when the work of
    every step sent is done.  With spans on, each step's device
    milliseconds of ``loss_and_grad`` and of the optimizer step."""
    card = run.device.type == "cuda"
    run.state["events"] = [] if card else None
    lag = run.state["lag"]
    pending: collections.deque = collections.deque()
    n = 0
    synchronize(run.device)
    t0 = time.perf_counter()
    while True:
        pending.append(step(run))
        n += 1
        if len(pending) > lag:
            float(pending.popleft())
        if time.perf_counter() - t0 >= seconds:
            break
    for loss in pending:
        float(loss)
    synchronize(run.device)
    t1 = time.perf_counter()
    events = run.state.pop("events") or []
    return {"ops": n, "seconds": t1 - t0,
            "fwd_bwd_ms": [a.elapsed_time(b) for a, b, _ in events],
            "opt_step_ms": [b.elapsed_time(c) for _, b, c in events]}


def end_to_end(run) -> dict:
    w, tr = run.timed, run.traffic
    return {"train_tokens_per_s":
            w["ops"] * tr["batch"] * tr["seq"] / w["seconds"]}


def facts(run) -> None:
    pass


def release(run) -> None:
    for k in ("params", "opt_state", "opt", "mod"):
        run.state.pop(k, None)
    gc.collect()
    if run.device.type == "cuda":
        from repro_torch.kernels.stream_copy import ops as sc_ops
        torch.cuda.synchronize(run.device)
        sc_ops.HELD.release()
        torch.cuda.empty_cache()


def check(run) -> list:
    """``(name, value, limit)`` of the checked steps against the
    reference's."""
    got = run.state["readings"]
    want = ref.train_readings(run.config, run.traffic, run.seed, run.device,
                              against=got.pop("first_grads"))
    gaps = ref.compare(got, want)
    limits = run.config["limits"]
    return [(k, v, float(limits[k])) for k, v in gaps.items()]
