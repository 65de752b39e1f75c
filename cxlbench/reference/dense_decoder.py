"""A dense decoder (starcoder2's block) and AdamW, written plainly from
their equations, in float32 with TF32 off, for three training steps.

The block: pre-LayerNorm (eps 1e-5), attention with q/k/v biases, rotary
embeddings over interleaved pairs of each head's dimensions (the layout
the port and its JAX package use; the published model rotates the two
halves, which is the same function under a fixed permutation of the q
and k columns), grouped KV heads, a causal mask with a sliding window,
softmax in float32; a GELU (tanh) MLP of two matrices; a final
LayerNorm; the head tied to the embedding; the mean next-token
cross-entropy.  Each layer is recomputed in the backward pass, so the
reference fits beside nothing else on the card.

AdamW: global-norm clipping, then ``mu = b1 mu + (1 - b1) g``,
``nu = b2 nu + (1 - b2) g^2``, ``p -= lr_t ((mu / c1) / (sqrt(nu / c2) +
eps) + wd p)`` with ``c = 1 - b^t`` and ``lr_t`` a one-step warm-up
then a cosine to a tenth over ``total_steps``.

``precision="fp8"`` computes every matrix product as fp8 training does:
both inputs rounded to float8 e4m3 going forward, the incoming gradient
to e5m2 and the saved inputs to e4m3 going back, a scale a tensor: the
control, one precision step below the bf16 the configuration states.
``fault`` plants a fault in the training loop: ``"half_batch"`` takes the
loss over the first half of the rows, ``"frozen"`` leaves the state as
it was after each step."""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cxlbench import traffic as traffic_mod
from cxlbench import weights

#: AdamW's settings (the configuration file's ``assumed.optimizer``)
B1, B2, EPS, WEIGHT_DECAY, CLIP = 0.9, 0.95, 1e-8, 0.1, 1.0
#: elements summed at once for a norm
NORM_CHUNK = 1 << 26


@contextlib.contextmanager
def full_fp32():
    """float32 matrix products and convolutions without TF32."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def to_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to ``dtype`` at a scale of its own (its largest
    magnitude to the format's), returned in ``x``'s dtype."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class Fp8MatMul(torch.autograd.Function):
    """``a @ b`` (``b`` a matrix, or batched like ``a``) with fp8 inputs
    both ways."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = to_fp8(g, torch.float8_e5m2)
        ga = gq @ bq.transpose(-1, -2)
        if bq.dim() == 2:
            gb = aq.reshape(-1, aq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        else:
            gb = aq.transpose(-1, -2) @ gq
        return ga, gb


def lr_factor(step: int, total_steps: int, min_frac: float = 0.1) -> float:
    """Step ``step`` (from 1): a linear warm-up over ``min(100, total //
    10)`` steps, then a cosine to ``min_frac``."""
    warm = min(100, total_steps // 10)
    if step < warm:
        return step / max(warm, 1)
    prog = min(max((step - warm) / max(total_steps - warm, 1), 0.0), 1.0)
    return min_frac + (1 - min_frac) * 0.5 * (1 + math.cos(math.pi * prog))


class Decoder:
    def __init__(self, config: dict, w: dict, precision: str = "fp32"):
        self.c, self.w = config, w
        self.low = precision == "fp8"
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return Fp8MatMul.apply(a, b) if self.low else a @ b

    def rope(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, heads, hd), positions 0..S-1, interleaved pairs."""
        S, hd = x.shape[1], x.shape[-1]
        inv = 1.0 / self.c["rope_theta"] ** (
            torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
        ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
            * inv
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape)

    def layer(self, x: torch.Tensor, i: int) -> torch.Tensor:
        c, w = self.c, self.w
        B, S, D = x.shape
        H, K, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                    c["head_dim"])
        eps = c["norm_epsilon"]
        h = F.layer_norm(x, (D,), w["layers.ln1.scale"][i],
                         w["layers.ln1.bias"][i], eps)
        q = self.mm(h, w["layers.attn.wq"][i])
        k = self.mm(h, w["layers.attn.wk"][i])
        v = self.mm(h, w["layers.attn.wv"][i])
        if "layers.attn.bq" in w:
            q = q + w["layers.attn.bq"][i]
            k = k + w["layers.attn.bk"][i]
            v = v + w["layers.attn.bv"][i]
        q = self.rope(q.view(B, S, H, hd))
        k = self.rope(k.view(B, S, K, hd)).repeat_interleave(H // K, dim=2)
        v = v.view(B, S, K, hd).repeat_interleave(H // K, dim=2)
        scores = self.mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) \
            / math.sqrt(hd)  # (B, H, S, S)
        pos = torch.arange(S, device=x.device)
        seen = pos[:, None] >= pos[None, :]
        if c.get("sliding_window"):
            seen &= pos[:, None] - pos[None, :] < c["sliding_window"]
        probs = torch.softmax(scores.masked_fill(~seen, float("-inf")), -1)
        o = self.mm(probs, v.transpose(1, 2)).transpose(1, 2)
        x = x + self.mm(o.reshape(B, S, H * hd), w["layers.attn.wo"][i])
        h = F.layer_norm(x, (D,), w["layers.ln2.scale"][i],
                         w["layers.ln2.bias"][i], eps)
        up = F.gelu(self.mm(h, w["layers.mlp.w_up"][i]), approximate="tanh")
        return x + self.mm(up, w["layers.mlp.w_down"][i])

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor
             ) -> torch.Tensor:
        c, w = self.c, self.w
        x = w["embed"][tokens]
        for i in range(c["num_hidden_layers"]):
            x = checkpoint(self.layer, x, i, use_reentrant=False)
        x = F.layer_norm(x, (c["hidden_size"],), w["final_norm.scale"],
                         w["final_norm.bias"], c["norm_epsilon"])
        head = w["embed"].T if c["tie_word_embeddings"] else w["lm_head"]
        logits = self.mm(x, head)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))


def sq_norm(x: torch.Tensor) -> float:
    """Sum of squares of ``x`` in float64, a chunk at a time."""
    flat = x.reshape(-1)
    return sum(float(torch.sum(flat[lo:lo + NORM_CHUNK].to(torch.float64)
                               ** 2))
               for lo in range(0, flat.numel(), NORM_CHUNK))


def gap_sq_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    """Sum of squares of ``a - b`` in float64, a chunk at a time."""
    fa, fb = a.reshape(-1), b.reshape(-1)
    total = 0.0
    for lo in range(0, fa.numel(), NORM_CHUNK):
        d = fa[lo:lo + NORM_CHUNK].to(fb.device, torch.float64) \
            - fb[lo:lo + NORM_CHUNK].to(torch.float64)
        total += float(torch.sum(d * d))
    return total


def train_readings(config: dict, traffic: dict, seed: int,
                   device: torch.device, *, precision: str = "fp32",
                   fault: Optional[str] = None,
                   against: Optional[dict] = None,
                   keep_grads: bool = False) -> dict:
    """The checked steps of a cell, plainly: ``losses`` of each step,
    ``grad_norms`` (each leaf's clipped first gradient), ``change_norms``
    (each leaf's change over the steps); with ``against`` (another run's
    clipped first gradients, host tensors by leaf) ``grad_diffs``, the
    norm of each leaf's difference from them; with ``keep_grads`` this
    run's own (``first_grads``, on the host)."""
    leaves = weights.dense_leaves(config)
    steps = int(traffic["checked_steps"])
    with full_fp32():
        w = {leaf.name: weights.make_leaf(leaf, i, seed, device).float()
             .requires_grad_(True) for i, leaf in enumerate(leaves)}
        model = Decoder(config, w, precision)
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
            grads = torch.autograd.grad(loss, list(w.values()))
            out["losses"].append(float(loss.detach()))
            g = dict(zip(w, grads))
            del grads
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
            if fault == "frozen":
                continue
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
        for i, leaf in enumerate(leaves):
            start = weights.make_leaf(leaf, i, seed, device)
            out["change_norms"][leaf.name] = math.sqrt(
                gap_sq_norm(w[leaf.name].detach(), start))
            del start
    return out


def moved_leaves(ref_grad_norms: dict) -> list[str]:
    """Leaves whose first gradient in the reference is at least a
    thousandth of the median leaf's: the others (a key's bias under
    softmax) move by round-off alone."""
    vals = sorted(ref_grad_norms.values())
    median = vals[len(vals) // 2]
    return [k for k, v in ref_grad_norms.items() if v >= 1e-3 * median]


def worst_leaf_share(values: dict, want: dict, keep) -> float:
    """Largest of ``values`` over the leaves in ``keep``, each against the
    larger of its leaf's ``want`` and the median leaf's."""
    vals = sorted(want[k] for k in keep)
    median = vals[len(vals) // 2]
    return max(values[k] / max(want[k], median, 1e-300) for k in keep)


def compare(got: dict, want: dict) -> dict:
    """The numbers a training cell is judged by, each by the worst leaf:
    the first gradient's difference from the reference's (``want`` holds
    it, made against ``got``'s gradients), and the gap between the norms
    of each leaf's change over the steps."""
    keep = moved_leaves(want["grad_norms"])
    return {"grad_diff": worst_leaf_share(want["grad_diffs"],
                                          want["grad_norms"], keep),
            "update_norm_gap": worst_leaf_share(
                {k: abs(got["change_norms"][k] - want["change_norms"][k])
                 for k in keep}, want["change_norms"], keep)}


def loss_gaps(got: dict, want: dict) -> list[float]:
    """Each step's loss against the reference's, relative (reported by
    the control runs, not compared: see the configuration's limits)."""
    return [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                 want["losses"])]
