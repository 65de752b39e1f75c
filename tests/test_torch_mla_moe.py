"""DeepSeek-V2-Lite in the port: the configuration beside the reference's
ten, YaRN's tables against its formula written out, raw (unnormalised)
gates, the held-expert layer against the benchmark's plain reference and
its shares adding up to the whole layer, the old routing bit for bit, and
decode and serving refused.  The whole model against the plain reference
is in ``cxlbench/tests/test_cxlbench_mla_moe.py``."""
from __future__ import annotations

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from cxlbench.reference import mla_moe_decoder as ref  # noqa: E402
from repro_torch.configs import deepseek_v2_lite as dsv2  # noqa: E402
from repro_torch.configs.base import (HeldMoESpec, MoESpec,  # noqa: E402
                                      YarnSpec)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common, mla, moe, registry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these shapes are tiny, and beside other test
    processes on the same cores more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_the_configuration_is_found_beside_the_ten():
    import repro.models.registry as r_registry
    assert registry.ARCH_IDS == r_registry.ARCH_IDS
    assert len(registry.ARCH_IDS) == 10
    assert "deepseek-v2-lite" not in registry.ARCH_IDS
    arch = registry.get("deepseek-v2-lite")
    assert arch.module is moe and arch.cfg is dsv2.CONFIG
    assert registry.get_config("deepseek-v2-lite").mla.kv_lora_rank == 512
    # the ten keep the reference's fields: the switches are not fields
    names = {f.name for f in dataclasses.fields(MoESpec)}
    assert not names & {"norm_topk", "n_held", "first_held",
                        "seq_aux_alpha"}
    spec = registry.get_config("deepseek-moe-16b").moe
    assert spec.norm_topk and not spec.seq_aux_alpha


def test_the_held_share_counts_the_published_sizes():
    """3,110,989,312 parameters with 8 of 64 experts held, as the cell's
    configuration states; the port's count leaves norms out."""
    cfg = dsv2.held_share(dsv2.CONFIG, 8)
    norms = 27 * (2 * 2048 + 512) + 2048
    assert cfg.param_count() + norms == 3_110_989_312
    assert list(cfg.moe.held) == list(range(8))
    with pytest.raises(ValueError, match="outside"):
        dsv2.held_share(dsv2.CONFIG, 8, first_held=60)


def _yarn_by_hand(dim, theta, factor, L, fast, slow):
    """DeepSeek-V2's YaRN, element by element in Python floats."""
    def turns(r):
        return dim * math.log(L / (r * 2 * math.pi)) / (2 * math.log(theta))
    low = max(math.floor(turns(fast)), 0)
    high = min(math.ceil(turns(slow)), dim - 1)
    out = []
    for i in range(dim // 2):
        extra = 1.0 / theta ** (2 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        out.append(extra / factor * ramp + extra * (1 - ramp))
    return out


@pytest.mark.parametrize("dim, factor, L", [(64, 40.0, 4096),
                                            (8, 40.0, 4096),
                                            (32, 4.0, 512)])
def test_yarn_tables_follow_the_formula(dim, factor, L):
    y = YarnSpec(factor=factor, original_max_position=L, beta_fast=32.0,
                 beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707)
    want = torch.tensor(_yarn_by_hand(dim, 10_000.0, factor, L, 32.0, 1.0))
    got = common.yarn_freqs(dim, 10_000.0, y)
    torch.testing.assert_close(got, want.float(), rtol=1e-6, atol=0)
    pos = torch.arange(7)[None]
    cos, sin = common.yarn_tables(pos, dim, 10_000.0, y)
    # mscale / mscale_all_dim = 1 here: plain cos and sin of the angles
    ang = pos[0, :, None].float() * got
    torch.testing.assert_close(cos[0, :, 0], torch.cos(ang))
    torch.testing.assert_close(sin[0, :, 0], torch.sin(ang))
    # the benchmark's reference (float64) agrees to fp32 rounding
    torch.testing.assert_close(got, ref.yarn_inv_freq(
        dim, 10_000.0, {"factor": factor, "original_max_position_embeddings":
                        L, "beta_fast": 32, "beta_slow": 1}).float(),
        rtol=1e-6, atol=0)


def test_yarn_blends_fast_dims_extrapolated_and_slow_ones_interpolated():
    y = dsv2.CONFIG.yarn
    got = common.yarn_freqs(64, 10_000.0, y)
    plain = common.rope_freqs(64, 10_000.0)
    # pairs 0..10 turn 32+ times over 4,096 positions: kept; 23..31 turn
    # under once: divided by the factor
    torch.testing.assert_close(got[:11], plain[:11])
    torch.testing.assert_close(got[23:], plain[23:] / 40)


def test_the_softmax_scale_carries_mscale_squared():
    scale = common.yarn_softmax_scale(192, dsv2.CONFIG.yarn)
    assert scale == pytest.approx((0.1 * 0.707 * math.log(40) + 1) ** 2
                                  / math.sqrt(192), rel=1e-12)
    assert scale * math.sqrt(192) == pytest.approx(1.5896, abs=1e-4)
    assert common.yarn_softmax_scale(192, None) == 192 ** -0.5


def _tiny(n_experts=8, n_held=0, first_held=0, top_k=3, norm_topk=False):
    cfg = dsv2.CONFIG.tiny()
    return dataclasses.replace(cfg, moe=HeldMoESpec(
        n_experts=n_experts, top_k=top_k, expert_d_ff=32, n_shared=2,
        shared_d_ff=32, first_dense=1, router_zloss=0.0,
        norm_topk=norm_topk, n_held=n_held, first_held=first_held,
        seq_aux_alpha=1e-3))


def _layer(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return moe.moe_layer_params(cfg, gen, "cpu")


@pytest.mark.parametrize("norm_topk", [False, True])
def test_raw_gates_sum_under_one(norm_topk):
    cfg = _tiny(norm_topk=norm_topk)
    lp = _layer(cfg)
    x = torch.randn(64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    route = moe._route(x, lp["router"], cfg.moe, 64)
    sums = torch.zeros(64).index_add_(0, route.order // cfg.moe.top_k,
                                      route.weights)
    if norm_topk:
        torch.testing.assert_close(sums, torch.ones(64))
    else:
        assert float(sums.max()) < 1 and float(sums.min()) > 0
        top = torch.topk(torch.softmax(x @ lp["router"], -1), 3).values
        torch.testing.assert_close(sums, top.sum(-1))


def test_deepseek_moe_16b_routes_as_before_bit_for_bit():
    """The renormalised top-k gates of the reference's formula, sorted by
    expert, are what ``_route`` gives for a configuration of the ten."""
    spec = registry.get_config("deepseek-moe-16b").tiny().moe
    g = torch.Generator().manual_seed(3)
    x = torch.randn(40, 64, generator=g)
    router = torch.randn(64, spec.n_experts, generator=g)
    route = moe._route(x, router, spec, moe.capacity(40, spec))
    probs = torch.softmax(x @ router, dim=-1)
    w, ids = torch.topk(probs, spec.top_k, dim=-1)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    order = torch.argsort(ids.reshape(-1), stable=True)
    assert torch.equal(route.weights,
                       (w.reshape(-1)[order] * route.keep).to(x.dtype))


def _ref_config(cfg) -> dict:
    """The plain reference's keys for a port configuration."""
    m, y = cfg.mla, cfg.yarn
    return {"hidden_size": cfg.d_model, "num_attention_heads": cfg.n_heads,
            "kv_lora_rank": m.kv_lora_rank,
            "qk_nope_head_dim": m.qk_nope_head_dim,
            "qk_rope_head_dim": m.qk_rope_head_dim,
            "v_head_dim": m.v_head_dim, "rms_norm_eps": 1e-6,
            "rope_theta": cfg.rope_theta,
            "rope_scaling": {"factor": y.factor, "mscale": y.mscale,
                             "mscale_all_dim": y.mscale_all_dim,
                             "beta_fast": y.beta_fast,
                             "beta_slow": y.beta_slow,
                             "original_max_position_embeddings":
                                 y.original_max_position},
            "published": {"n_routed_experts": cfg.moe.n_experts},
            "num_experts_per_tok": cfg.moe.top_k,
            "n_routed_experts": len(cfg.moe.held),
            "first_held_expert": cfg.moe.held.start}


def _ref_weights(lp: dict, prefix: str = "units.moe") -> tuple:
    """(the port layer's tensors as leaves that record gradients, stacked
    over one layer, by the reference's names; the port's tree of views of
    them)."""
    out = {}

    def walk(node, name):
        tree = {}
        for k, v in node.items():
            if isinstance(v, dict):
                tree[k] = walk(v, f"{name}.{k}")
            else:
                leaf = v[None].clone().requires_grad_(True)
                out[f"{name}.{k}"] = leaf
                tree[k] = leaf[0]
        return tree
    return out, walk(lp, prefix)


def test_the_shares_add_up_to_the_whole_layer():
    """Eight cards of one expert each: their parts of the layer, the
    shared experts counted once, add up to the reference's layer with
    every expert held.  fp32; the sums run in another order, so 1e-5."""
    whole = _tiny(n_held=8)
    lp = _layer(whole)
    B, S = 2, 24
    h = torch.randn(B, S, whole.d_model, generator=torch.Generator()
                    .manual_seed(2))
    want, want_bal = ref.Decoder(_ref_config(whole),
                                 _ref_weights(lp)[0]).moe(h, 0)
    shared = moe.mlp_apply(h.reshape(B * S, -1), lp["shared"], whole.act)
    total = shared.clone()
    for e in range(8):
        cfg = _tiny(n_held=1, first_held=e)
        part = dict(lp, experts={k: v[e:e + 1]
                                 for k, v in lp["experts"].items()})
        y, aux = moe.held_moe_mlp(h.reshape(B * S, -1), part, cfg.moe,
                                  cfg.act, n_seqs=B)
        total += y - shared
        assert float(aux["expert_counts"]) == float(
            (torch.topk(torch.softmax(h.reshape(B * S, -1) @ lp["router"],
                                      -1), 3).indices == e).sum())
        torch.testing.assert_close(aux["seq_lb"], want_bal)
    torch.testing.assert_close(total.view(B, S, -1), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("first_held", [0, 3, 6])
def test_a_held_share_matches_the_reference_share(first_held):
    """Output and every gradient of one card's share of the layer against
    the reference's share, fp32 (sums in another order: 1e-5)."""
    cfg = _tiny(n_held=2, first_held=first_held)
    lp = _layer(cfg, seed=first_held)
    B, S = 2, 16
    h = torch.randn(B, S, cfg.d_model, generator=torch.Generator()
                    .manual_seed(5)).requires_grad_(True)
    leaves, port = _ref_weights(lp)
    y, aux = moe.held_moe_mlp(h.reshape(B * S, -1), port, cfg.moe, cfg.act,
                              n_seqs=B)
    got = torch.autograd.grad(y.square().sum() + aux["seq_lb"],
                              [h] + list(leaves.values()), allow_unused=True)
    want, bal = ref.Decoder(_ref_config(cfg), leaves).moe(h, 0)
    exp = torch.autograd.grad(want.square().sum() + bal,
                              [h] + list(leaves.values()), allow_unused=True)
    torch.testing.assert_close(y.view(B, S, -1), want, rtol=1e-5, atol=1e-5)
    names = ["h"] + list(leaves)
    assert [n for n, a in zip(names, got) if a is None] == [
        n for n, b in zip(names, exp) if b is None] == [
        n for n in names if ".attn." in n or ".ln" in n]
    for name, a, b in zip(names, got, exp):
        if b is not None:
            # fp32 sums in another order, gradients of order 10
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


def test_latent_attention_matches_the_reference():
    """One layer's MLA with YaRN, output and gradients, fp32 (the port
    takes scores in chunks of 8 queries here)."""
    cfg = _tiny()
    gen = torch.Generator().manual_seed(4)
    p = mla.mla_params(gen, cfg, torch.float32)
    with torch.no_grad():
        p["kv_norm"].uniform_(0.5, 1.5, generator=gen)
    leaves = {f"units.moe.attn.{k}": v[None].clone().requires_grad_(True)
              for k, v in p.items()}
    B, S = 2, 24
    h = torch.randn(B, S, cfg.d_model, generator=gen)
    pos = torch.arange(S)[None].expand(B, S)
    port = {k.split(".")[-1]: v[0] for k, v in leaves.items()}
    with common.activation_sharding({"_q_chunk": 8}):
        got = mla.mla_attention(h, port, cfg, pos)
    want = ref.Decoder(_ref_config(cfg), leaves).attention(h, "units.moe", 0)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    g_got = torch.autograd.grad(got.square().sum(), list(leaves.values()))
    g_want = torch.autograd.grad(want.square().sum(), list(leaves.values()))
    for k, a, b in zip(leaves, g_got, g_want):
        # fp32 sums in another order, gradients of order 100
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=k)


def test_latent_decode_and_serving_are_refused():
    cfg = dsv2.CONFIG.tiny()
    with pytest.raises(NotImplementedError, match="MLA"):
        moe.init_cache(cfg, 2, 8, device="cpu")
    params = moe.init(cfg, 0, device="cpu")
    cache = {"k": None, "v": None, "len": torch.zeros(2, dtype=torch.int32)}
    with pytest.raises(NotImplementedError, match="MLA"):
        moe.decode_step(cfg, params, cache, torch.zeros(2, dtype=torch.long))
    with pytest.raises(SystemExit, match="MLA"):
        serve.main(["--arch", "deepseek-v2-lite", "--tiny", "--device", "cpu",
                    "--requests", "1"])


def test_it_trains_through_the_normal_path():
    """``train.build`` with the configuration, ``loss_and_grad`` with
    remat, ``adamw.apply``: the loss falls over a few steps on one
    batch, and the held histogram is counted on the device."""
    from repro_torch.launch import train
    from repro_torch.optim import adamw
    cfg = dsv2.held_share(dsv2.CONFIG, 8).tiny()
    arch, opt_cfg, opt, params, state, n, _, _ = train.build(
        "deepseek-v2-lite", tiny=True, batch=2, seq=16, lr=3e-3,
        total_steps=10, offload_fraction=0.0, device="cpu", cfg=cfg)
    assert opt is None and n == sum(p.numel() for p in params.parameters())
    g = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab, (2, 17), generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    counts = torch.zeros(len(cfg.moe.held))
    losses = []
    for _ in range(4):
        loss, grads = arch.module.loss_and_grad(cfg, params, batch,
                                                remat=True,
                                                expert_counts=counts)
        adamw.apply(opt_cfg, params, grads, state)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    # 4 steps x 2 MoE layers x 32 tokens x 2 choices over 4 experts
    assert 0 < float(counts.sum()) <= 4 * 2 * 32 * 2


@pytest.mark.cuda
def test_the_grouped_products_match_a_product_a_group_on_the_card():
    """bf16 ``torch._grouped_mm`` over device ends against the product a
    group in fp32 of the same bf16 inputs, with an empty group and rows
    past the last end; gradients too.  Only the bf16 rounding of the
    results and the order of the sums differ: 1e-2 of the largest value.
    An empty group's weight gradient is zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(512, 256, generator=g, device=dev).bfloat16()
    w = (torch.randn(4, 256, 128, generator=g, device=dev) / 16).bfloat16()
    gy = torch.randn(512, 128, generator=g, device=dev).bfloat16()
    gy[400:] = 0
    ends = torch.tensor([100, 100, 260, 400], dtype=torch.int32, device=dev)
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    xf, wf = x.float().requires_grad_(True), w.float().requires_grad_(True)
    got = moe.grouped_mm(xb, wb, ends)
    want = moe.grouped_mm_by_group(xf, wf, ends)
    got.backward(gy)
    want.backward(gy.float())

    def close(a, b):
        a, b = a.detach().float(), b.detach()
        torch.testing.assert_close(a, b, rtol=1e-2,
                                   atol=1e-2 * float(b.abs().max()))
    close(got[:400], want[:400])
    close(xb.grad[:400], xf.grad[:400])
    for e in (0, 2, 3):
        close(wb.grad[e], wf.grad[e])
    assert not wb.grad[1].any()
