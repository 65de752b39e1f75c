"""DeepSeek-V2's decoder on one card of an expert-parallel deployment, and
AdamW, written plainly from their equations (arXiv:2405.04434), in float32
with TF32 off, for the checked steps of a training cell.

The layers: pre-RMSNorm (eps from the configuration); multi-head latent
attention without a query LoRA: ``q = x Wq`` splits per head into an
unrotated and a rotary part, ``[c, k_pe] = x Wkv_a``, ``c`` RMS-normed,
``[k_nope, v] = c Wkv_b`` per head, the one rotary key shared by every
head; the rotary parts turned by YaRN's frequencies (their ramp between
``beta_fast`` and ``beta_slow`` turns over the original context, cos and
sin times ``mscale(mscale) / mscale(mscale_all_dim)``) over interleaved
pairs of dimensions, which is how the published model reads its rotary
dimensions; scores over both parts at ``qk_head_dim ** -0.5`` times
``mscale(mscale_all_dim)`` squared, a causal mask, softmax; ``Wo``.  The
first ``first_k_dense_replace`` layers end in a SwiGLU MLP; the others in
a MoE layer: a softmax over the ``published.n_routed_experts`` router
outputs, the greedy top ``num_experts_per_tok``, gates the raw
probabilities (``norm_topk_prob`` false), the held experts
``[first_held_expert, first_held_expert + n_routed_experts)`` computed one
at a time over the tokens routed to them, what the other experts would
add left out (another card's part), and the shared experts (one SwiGLU
MLP ``n_shared_experts`` times as wide).  The loss is the mean next-token
cross-entropy of an untied head, taken over blocks of tokens, plus
``aux_loss_alpha`` times the sequence-wise balance term summed over the
MoE layers.  Each layer is recomputed in the backward pass and each
sequence's attention is taken alone, so the reference fits on the card
once the program's state is freed.

AdamW as ``dense_decoder``'s.  ``precision="fp8"`` takes every product
but the router's (float32 in the configuration too) in fp8, as
``dense_decoder``'s control does.  ``fault`` plants one fault:
``"renorm_gates"`` divides the top-k gates by their sum,
``"plain_rope"`` turns the rotary parts by plain RoPE and scales scores by
``qk_head_dim ** -0.5``, ``"no_latent_norm"`` leaves the latent's RMSNorm
out, ``"half_batch"`` takes the loss over the first half of the rows (as
``dense_decoder``'s)."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cxlbench import traffic as traffic_mod
from cxlbench import weights
from cxlbench.reference.dense_decoder import (B1, B2, CLIP, EPS,
                                              WEIGHT_DECAY, Fp8MatMul,
                                              full_fp32, gap_sq_norm,
                                              lr_factor, sq_norm)
from cxlbench.weights import Leaf

FAULTS = ("renorm_gates", "plain_rope", "no_latent_norm", "half_batch")
#: tokens a block of the head and loss takes at once
HEAD_BLOCK = 2048


def leaves(config: dict) -> list[Leaf]:
    """Every leaf, stacked over the dense layers (``head_dense``) and the
    MoE layers (``units.moe``), by the port's names: normal(0, 0.02) the
    embedding and the head, normal(0, 1/fan_in) each projection, the
    router float32, RMSNorm scales at 1 (float32)."""
    c = config
    Ld = c["first_k_dense_replace"]
    Lm = c["num_hidden_layers"] - Ld
    D, H, V = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    r, nope = c["kv_lora_rank"], c["qk_nope_head_dim"]
    rd, vd = c["qk_rope_head_dim"], c["v_head_dim"]
    F_, f = c["intermediate_size"], c["moe_intermediate_size"]
    n, Fs = c["n_routed_experts"], c["n_shared_experts"] * f
    E = c["published"]["n_routed_experts"]
    wdt, f32 = weights.DTYPES[c["torch_dtype"]], torch.float32

    def w(name, shape, fan_in):
        return Leaf(name, shape, wdt, "normal", 1 / math.sqrt(fan_in))

    def block(pre: str, L: int) -> list[Leaf]:
        return [Leaf(f"{pre}.ln1.scale", (L, D), f32, "ones"),
                w(f"{pre}.attn.wq", (L, D, H * (nope + rd)), D),
                w(f"{pre}.attn.wkv_a", (L, D, r + rd), D),
                Leaf(f"{pre}.attn.kv_norm", (L, r), f32, "ones"),
                w(f"{pre}.attn.wkv_b", (L, r, H * (nope + vd)), r),
                w(f"{pre}.attn.wo", (L, H * vd, D), H * vd),
                Leaf(f"{pre}.ln2.scale", (L, D), f32, "ones")]

    out = [Leaf("embed", (V, D), wdt, "normal", 0.02)]
    out += block("head_dense", Ld) + [
        w("head_dense.mlp.w_gate", (Ld, D, F_), D),
        w("head_dense.mlp.w_up", (Ld, D, F_), D),
        w("head_dense.mlp.w_down", (Ld, F_, D), F_)]
    out += block("units.moe", Lm) + [
        Leaf("units.moe.router", (Lm, D, E), f32, "normal", 1 / math.sqrt(D)),
        w("units.moe.experts.w_gate", (Lm, n, D, f), D),
        w("units.moe.experts.w_up", (Lm, n, D, f), D),
        w("units.moe.experts.w_down", (Lm, n, f, D), f),
        w("units.moe.shared.w_gate", (Lm, D, Fs), D),
        w("units.moe.shared.w_up", (Lm, D, Fs), D),
        w("units.moe.shared.w_down", (Lm, Fs, D), Fs)]
    out += [Leaf("final_norm.scale", (D,), f32, "ones"),
            Leaf("lm_head", (D, V), wdt, "normal", 0.02)]
    return out


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, theta: float, rs: dict) -> torch.Tensor:
    """(dim/2,) float64 inverse frequencies of YaRN's blend."""
    idx = torch.arange(dim // 2, dtype=torch.float64)
    extra = theta ** (-2 * idx / dim)
    inter = extra / rs["factor"]
    L = rs["original_max_position_embeddings"]

    def turns_dim(rotations):
        return dim * math.log(L / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))
    low = max(math.floor(turns_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(turns_dim(rs["beta_slow"])), dim - 1)
    ramp = ((idx - low) / max(high - low, 1e-3)).clamp(0, 1)
    return inter * ramp + extra * (1 - ramp)


class Decoder:
    def __init__(self, config: dict, w: dict, precision: str = "fp32",
                 fault: Optional[str] = None):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.c, self.w = config, w
        self.low, self.fault = precision == "fp8", fault

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return Fp8MatMul.apply(a, b) if self.low else a @ b

    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.c["rms_norm_eps"]) * scale

    def rotary(self, S: int, device) -> tuple:
        """(cos, sin) (S, 1, rope/2) and the softmax scale."""
        c, rs = self.c, self.c["rope_scaling"]
        dim = c["qk_rope_head_dim"]
        qk = c["qk_nope_head_dim"] + dim
        if self.fault == "plain_rope":
            inv = c["rope_theta"] ** (
                -torch.arange(0, dim, 2, dtype=torch.float64) / dim)
            m, scale = 1.0, qk ** -0.5
        else:
            inv = yarn_inv_freq(dim, c["rope_theta"], rs)
            m = yarn_mscale(rs["factor"], rs["mscale"]) \
                / yarn_mscale(rs["factor"], rs["mscale_all_dim"])
            scale = qk ** -0.5 * yarn_mscale(rs["factor"],
                                             rs["mscale_all_dim"]) ** 2
        ang = torch.arange(S, dtype=torch.float64)[:, None] * inv
        cos = (torch.cos(ang) * m).to(device, torch.float32)[:, None, :]
        sin = (torch.sin(ang) * m).to(device, torch.float32)[:, None, :]
        return cos, sin, scale

    @staticmethod
    def rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
        """x (S, heads, d): pairs (x[2i], x[2i+1]) turned by angle i."""
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape)

    def attention(self, h: torch.Tensor, pre: str, i: int) -> torch.Tensor:
        c, w = self.c, self.w
        B, S, D = h.shape
        H, r = c["num_attention_heads"], c["kv_lora_rank"]
        nope, rd, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                        c["v_head_dim"])
        cos, sin, scale = self.rotary(S, h.device)
        seen = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
        outs = []
        for b in range(B):  # one sequence's scores at a time
            x = h[b]
            q = self.mm(x, w[f"{pre}.attn.wq"][i]).view(S, H, nope + rd)
            ckp = self.mm(x, w[f"{pre}.attn.wkv_a"][i])
            lat, k_pe = ckp[:, :r], ckp[:, r:]
            if self.fault != "no_latent_norm":
                lat = self.rms(lat, w[f"{pre}.attn.kv_norm"][i])
            kv = self.mm(lat, w[f"{pre}.attn.wkv_b"][i]).view(S, H, nope + vd)
            q = torch.cat([q[..., :nope], self.rope(q[..., nope:], cos, sin)],
                          -1)
            k_pe = self.rope(k_pe.view(S, 1, rd), cos, sin).expand(S, H, rd)
            k = torch.cat([kv[..., :nope], k_pe], -1)
            v = kv[..., nope:]
            scores = self.mm(q.transpose(0, 1), k.permute(1, 2, 0)) * scale
            probs = torch.softmax(scores.masked_fill(~seen, float("-inf")),
                                  -1)
            o = self.mm(probs, v.transpose(0, 1)).transpose(0, 1)  # (S,H,v)
            outs.append(self.mm(o.reshape(S, H * vd),
                                w[f"{pre}.attn.wo"][i]))
        return torch.stack(outs)

    def swiglu(self, x, wg, wu, wd) -> torch.Tensor:
        return self.mm(F.silu(self.mm(x, wg)) * self.mm(x, wu), wd)

    def moe(self, h: torch.Tensor, i: int) -> tuple:
        """(this card's part of the MoE layer, the sequence-wise balance
        term)."""
        c, w = self.c, self.w
        B, S, D = h.shape
        E, K = c["published"]["n_routed_experts"], c["num_experts_per_tok"]
        first = c["first_held_expert"]
        x = h.reshape(B * S, D)
        probs = torch.softmax(x @ w["units.moe.router"][i], -1)  # float32
        gates, ids = torch.topk(probs, K, dim=-1)
        if self.fault == "renorm_gates":
            gates = gates / gates.sum(-1, keepdim=True)
        y = self.swiglu(x, w["units.moe.shared.w_gate"][i],
                        w["units.moe.shared.w_up"][i],
                        w["units.moe.shared.w_down"][i])
        for e in range(c["n_routed_experts"]):
            tok, choice = torch.nonzero(ids == first + e, as_tuple=True)
            if not tok.numel():  # no pair routed here (fp8 scales need one)
                continue
            out = self.swiglu(x[tok], w["units.moe.experts.w_gate"][i][e],
                              w["units.moe.experts.w_up"][i][e],
                              w["units.moe.experts.w_down"][i][e])
            y = y.index_add(0, tok, gates[tok, choice][:, None] * out)
        counts = torch.zeros(B, E, device=h.device)
        for b in range(B):
            counts[b] = torch.bincount(ids.view(B, S * K)[b],
                                       minlength=E).float()
        f = counts * E / (S * K)
        balance = (f * probs.view(B, S, E).mean(1)).sum(1).mean()
        return y.view(B, S, D), balance

    def layer(self, x: torch.Tensor, pre: str, i: int) -> tuple:
        w = self.w
        x = x + self.attention(self.rms(x, w[f"{pre}.ln1.scale"][i]), pre, i)
        h = self.rms(x, w[f"{pre}.ln2.scale"][i])
        if pre == "head_dense":
            return x + self.swiglu(h, w["head_dense.mlp.w_gate"][i],
                                   w["head_dense.mlp.w_up"][i],
                                   w["head_dense.mlp.w_down"][i]), \
                torch.zeros((), device=x.device)
        y, balance = self.moe(h, i)
        return x + y, balance

    def block_nll(self, x: torch.Tensor, labels: torch.Tensor):
        logits = self.mm(x, self.w["lm_head"])
        return F.cross_entropy(logits, labels, reduction="sum")

    def hidden(self, tokens: torch.Tensor) -> tuple:
        """(the final norm's output (B, S, D), the balance terms summed
        over the MoE layers)."""
        c, w = self.c, self.w
        x = w["embed"][tokens]
        Ld = c["first_k_dense_replace"]
        aux = 0.0
        for j in range(c["num_hidden_layers"]):
            pre, i = ("head_dense", j) if j < Ld else ("units.moe", j - Ld)
            x, balance = checkpoint(self.layer, x, pre, i, use_reentrant=False)
            aux = aux + balance
        return self.rms(x, w["final_norm.scale"]), aux

    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.mm(self.hidden(tokens)[0], self.w["lm_head"])

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        c = self.c
        x, aux = self.hidden(tokens)
        x = x.reshape(-1, c["hidden_size"])
        flat = labels.reshape(-1)
        nll = sum(checkpoint(self.block_nll, x[lo:lo + HEAD_BLOCK],
                             flat[lo:lo + HEAD_BLOCK], use_reentrant=False)
                  for lo in range(0, flat.numel(), HEAD_BLOCK))
        return nll / flat.numel() + c["aux_loss_alpha"] * aux


def train_readings(config: dict, traffic: dict, seed: int,
                   device: torch.device, *, precision: str = "fp32",
                   fault: Optional[str] = None,
                   against: Optional[dict] = None,
                   keep_grads: bool = False) -> dict:
    """As ``dense_decoder.train_readings``, for this decoder: ``losses``,
    ``grad_norms`` (each leaf's clipped first gradient), ``change_norms``
    (each leaf's change over the checked steps), with ``against``
    ``grad_diffs``, with ``keep_grads`` ``first_grads`` (on the host)."""
    lv = leaves(config)
    steps = int(traffic["checked_steps"])
    with full_fp32():
        w = {leaf.name: weights.make_leaf(leaf, i, seed, device).float()
             .requires_grad_(True) for i, leaf in enumerate(lv)}
        model = Decoder(config, w, precision, fault)
        mu = {k: torch.zeros_like(p) for k, p in w.items()}
        nu = {k: torch.zeros_like(p) for k, p in w.items()}
        out = {"losses": [], "grad_norms": {}, "change_norms": {}}
        for s in range(steps):
            b = traffic_mod.token_batch(
                seed, s, batch=traffic["batch"], seq=traffic["seq"],
                vocab=config["vocab_size"], device=device)
            tokens, labels = b["tokens"], b["labels"]
            if fault == "half_batch":
                half = tokens.shape[0] // 2
                tokens, labels = tokens[:half], labels[:half]
            loss = model.loss(tokens, labels)
            grads = torch.autograd.grad(loss, list(w.values()),
                                        allow_unused=True)
            # a leaf the loss does not read (a planted fault's) gets zeros
            g = {k: torch.zeros_like(p) if x is None else x
                 for (k, p), x in zip(w.items(), grads)}
            del grads
            out["losses"].append(float(loss.detach()))
            norm = math.sqrt(sum(sq_norm(x) for x in g.values()))
            scale = min(1.0, CLIP / max(norm, 1e-9))
            if s == 0:
                out["grad_norms"] = {k: math.sqrt(sq_norm(x)) * scale
                                     for k, x in g.items()}
                if against is not None:
                    out["grad_diffs"] = {k: math.sqrt(gap_sq_norm(
                        against[k], x * scale)) for k, x in g.items()}
                if keep_grads:
                    out["first_grads"] = {k: (x * scale).cpu()
                                          for k, x in g.items()}
            t = s + 1
            lr = traffic["lr"] * lr_factor(t, traffic["total_steps"])
            c1, c2 = 1 - B1 ** t, 1 - B2 ** t
            with torch.no_grad():
                for k, p in w.items():
                    gk = g.pop(k) * scale
                    mu[k].mul_(B1).add_(gk, alpha=1 - B1)
                    nu[k].mul_(B2).addcmul_(gk, gk, value=1 - B2)
                    upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS) \
                        + WEIGHT_DECAY * p
                    p.sub_(lr * upd)
                    del gk, upd
        del mu, nu
        for i, leaf in enumerate(lv):
            start = weights.make_leaf(leaf, i, seed, device)
            out["change_norms"][leaf.name] = math.sqrt(
                gap_sq_norm(w[leaf.name].detach(), start))
            del start
    return out
