"""The weights and tables every cell is made of, drawn on the device from
the run's seed: the DLRM table, and a dense decoder's leaves by the
port's leaf names.  Each leaf has a generator of its own, so the
reference (and the check of a parameter's change) can make one leaf again
without the others.  Nothing here imports the program."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cxlbench.common import generator

#: input streams of a run (see ``common.generator``)
STREAM_TABLE, STREAM_LEAVES = 10, 100
#: elements drawn at once (bounds the fp32 temporary to 1 GiB)
CHUNK = 1 << 28

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal_into(out: torch.Tensor, std: float, gen) -> torch.Tensor:
    flat = out.view(-1)
    for lo in range(0, flat.numel(), CHUNK):
        n = min(CHUNK, flat.numel() - lo)
        x = torch.randn(n, generator=gen, dtype=torch.float32,
                        device=out.device)
        flat[lo:lo + n].copy_(x.mul_(std))
    return out


def dlrm_table(config: dict, seed: int, device: torch.device,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(rows, dim) standard-normal rows, rounded to ``dtype``."""
    out = torch.empty((int(config["rows"]), int(config["dim"])), dtype=dtype,
                      device=device)
    return _normal_into(out, 1.0, generator(seed, STREAM_TABLE, device))


class Leaf(NamedTuple):
    name: str
    shape: tuple
    dtype: torch.dtype
    #: "normal" (with ``std``), "ones" or "zeros"
    init: str
    std: float = 0.0


def dense_leaves(config: dict) -> list[Leaf]:
    """Every leaf of a dense decoder (layer norms, q/k/v biases, GQA, a
    two-matrix GELU MLP), stacked over the layers, by the port's names."""
    L, D = config["num_hidden_layers"], config["hidden_size"]
    H, K = config["num_attention_heads"], config["num_key_value_heads"]
    hd, F = config["head_dim"], config["intermediate_size"]
    V = config["vocab_size"]
    wdt = DTYPES[config["torch_dtype"]]
    f32 = torch.float32
    out = [Leaf("embed", (V, D), wdt, "normal", 0.02)]
    for ln in ("ln1", "ln2"):
        out += [Leaf(f"layers.{ln}.scale", (L, D), f32, "ones"),
                Leaf(f"layers.{ln}.bias", (L, D), f32, "zeros")]
    out += [Leaf("layers.attn.wq", (L, D, H * hd), wdt, "normal",
                 1 / math.sqrt(D)),
            Leaf("layers.attn.wk", (L, D, K * hd), wdt, "normal",
                 1 / math.sqrt(D)),
            Leaf("layers.attn.wv", (L, D, K * hd), wdt, "normal",
                 1 / math.sqrt(D)),
            Leaf("layers.attn.wo", (L, H * hd, D), wdt, "normal",
                 1 / math.sqrt(H * hd))]
    if config["use_bias"] in ("qkv", True):
        out += [Leaf("layers.attn.bq", (L, H * hd), wdt, "zeros"),
                Leaf("layers.attn.bk", (L, K * hd), wdt, "zeros"),
                Leaf("layers.attn.bv", (L, K * hd), wdt, "zeros")]
    out += [Leaf("layers.mlp.w_up", (L, D, F), wdt, "normal",
                 1 / math.sqrt(D)),
            Leaf("layers.mlp.w_down", (L, F, D), wdt, "normal",
                 1 / math.sqrt(F)),
            Leaf("final_norm.scale", (D,), f32, "ones"),
            Leaf("final_norm.bias", (D,), f32, "zeros")]
    if not config["tie_word_embeddings"]:
        out.append(Leaf("lm_head", (D, V), wdt, "normal", 0.02))
    return out


def make_leaf(leaf: Leaf, index: int, seed: int,
              device: torch.device) -> torch.Tensor:
    """Leaf ``index`` of :func:`dense_leaves`, in its own dtype."""
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    out = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    return _normal_into(out, leaf.std,
                        generator(seed, STREAM_LEAVES + index, device))


def dense_weights(config: dict, seed: int, device: torch.device) -> dict:
    """``{leaf name: tensor}`` of every leaf."""
    return {leaf.name: make_leaf(leaf, i, seed, device)
            for i, leaf in enumerate(dense_leaves(config))}
