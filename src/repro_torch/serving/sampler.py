"""Token samplers.  Random choices take an explicit ``torch.Generator``."""
from __future__ import annotations

import torch


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum per row, int32 (as ``jnp.argmax``)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def sample_temperature(logits: torch.Tensor, gen: torch.Generator,
                       temperature: float = 1.0) -> torch.Tensor:
    probs = torch.softmax(logits.to(torch.float32) / max(temperature, 1e-6),
                          dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=gen)[:, 0]
    return out.reshape(probs.shape[:-1])


def sample_topk(logits: torch.Tensor, gen: torch.Generator, k: int = 40,
                temperature: float = 1.0) -> torch.Tensor:
    vals, idx = torch.topk(logits, k, dim=-1)
    choice = sample_temperature(vals, gen, temperature)
    return torch.gather(idx, -1, choice[..., None])[..., 0]
