"""Dense decoder-only transformer parameters (qwen2.5/qwen1.5, starcoder2,
stablelm, the InternLM2 backbone of internvl2).

``init`` builds the parameters as an ``nn.Module`` whose names follow the
reference's tree — ``embed``, ``layers.ln1.scale``, ``layers.attn.wq``,
…, ``final_norm.scale``, ``lm_head`` (stored transposed, ``(D, V)``) —
with every layer parameter stacked over a leading ``L`` axis, as the
reference's ``vmap``-ed init stacks them.  ``forward``, ``loss`` and the
untiered ``decode_step`` come with the training slice; serving decodes
through :func:`repro_torch.serving.kv_cache.tiered_decode_step`."""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (dtype_of, embed_init, mlp_params,
                                       norm_params)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _group(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in tree.items()})


class DenseParams(nn.Module):
    """The parameter tree of one dense model (inference only: no grads)."""

    def __init__(self, embed: torch.Tensor, layers: dict, final_norm: dict,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = _frozen(embed)
        self.layers = nn.ModuleDict({k: _group(v) for k, v in layers.items()})
        self.final_norm = _group(final_norm)
        self.lm_head = None if lm_head is None else _frozen(lm_head)

    @property
    def n_layers(self) -> int:
        return self.layers["ln1"]["scale"].shape[0]

    def layer(self, i: int) -> dict:
        """Layer ``i``'s parameters as a dict tree of views (cached: the
        decode step reads every layer every step)."""
        views = self.__dict__.get("_layer_views")
        if views is None:
            views = [{g: {k: p[j] for k, p in grp.items()}
                      for g, grp in self.layers.items()}
                     for j in range(self.n_layers)]
            self.__dict__["_layer_views"] = views
        return views[i]


def init(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0, *,
         device: DeviceLike = None) -> DenseParams:
    """Random parameters from a seeded generator, made on ``device``
    (``cuda`` unless told ``"cpu"``)."""
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(seed))
    dt = dtype_of(cfg.param_dtype)
    D, L, hd = cfg.d_model, cfg.n_layers, cfg.resolved_head_dim
    embed = embed_init(gen, cfg.vocab_padded, D, dt, device=device)

    def stacked(make) -> dict:
        first = make()
        out = {k: torch.empty((L,) + tuple(v.shape), dtype=v.dtype,
                              device=device) for k, v in first.items()}
        for k, v in first.items():
            out[k][0] = v
        for i in range(1, L):
            for k, v in make().items():
                out[k][i] = v
        return out

    layers = {
        "ln1": stacked(lambda: norm_params(D, cfg.norm, torch.float32,
                                           device=device)),
        "attn": stacked(lambda: attn.attn_params(
            gen, D, cfg.n_heads, cfg.n_kv_heads, hd, dt, cfg.qkv_bias,
            device=device)),
        "ln2": stacked(lambda: norm_params(D, cfg.norm, torch.float32,
                                           device=device)),
        "mlp": stacked(lambda: mlp_params(gen, D, cfg.d_ff, cfg.act, dt,
                                          device=device)),
    }
    final_norm = norm_params(D, cfg.norm, torch.float32, device=device)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = embed_init(gen, cfg.vocab_padded, D, dt,
                             device=device).T.contiguous()
    return DenseParams(embed, layers, final_norm, lm_head)
