"""Differential tests for the port's model code: the ten configs field by
field, the primitives (norms, RoPE, MLPs) against ``repro.models.common``,
the parameter tree and its carry-over from JAX, the registry and the
samplers."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import common as r_common  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.serving import sampler as t_sampler  # noqa: E402

ARCHS = r_registry.ARCH_IDS
PORTED = ("starcoder2-3b", "qwen2.5-32b", "stablelm-12b", "internvl2-2b",
          "qwen1.5-32b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# -- configs -------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal_field_by_field(arch):
    r = r_registry.get_config(arch)
    t = t_registry.get_config(arch)
    assert type(t).__module__.startswith("repro_torch.")
    assert dataclasses.asdict(t) == dataclasses.asdict(r)
    assert dataclasses.asdict(t.tiny()) == dataclasses.asdict(r.tiny())
    for prop in ("vocab_padded", "resolved_head_dim", "sub_quadratic",
                 "is_encoder_decoder"):
        assert getattr(t, prop) == getattr(r, prop), prop
    assert t.param_count() == r.param_count()
    assert t.active_param_count() == r.active_param_count()
    assert t.layer_kinds() == r.layer_kinds()


def test_registry_ports_dense_and_vlm_only():
    """Every family goes to its module, as in the reference: dense and
    vlm to the transformer, ssm (rwkv6), moe, hybrid (RG-LRU) and audio
    (whisper) to their own (the name is older than slices 10 and 12)."""
    assert t_registry.ARCH_IDS == r_registry.ARCH_IDS
    ported = {"dense": "repro_torch.models.transformer",
              "vlm": "repro_torch.models.transformer",
              "ssm": "repro_torch.models.rwkv",
              "moe": "repro_torch.models.moe",
              "hybrid": "repro_torch.models.rglru",
              "audio": "repro_torch.models.whisper"}
    for arch in ARCHS:
        cfg = t_registry.get_config(arch)
        assert t_registry.get(arch).module.__name__ == ported[cfg.family]
        assert r_registry.get(arch).module.__name__ == \
            ported[cfg.family].replace("repro_torch", "repro")
    with pytest.raises(KeyError):
        t_registry.get("gpt-5")


def test_port_imports_neither_jax_nor_the_reference():
    """No module of ``repro_torch`` imports ``jax``, anything of ``repro``
    or the reference's top-level ``benchmarks`` figure scripts, which
    import JAX (the port runs where neither is installed; its own
    scripts are ``repro_torch.benchmarks``)."""
    import ast
    from pathlib import Path

    import repro_torch
    root = Path(repro_torch.__file__).parent
    files = sorted(root.rglob("*.py"))
    assert len(files) > 40
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro", "benchmarks"), \
                    (path, name)


# -- primitives ----------------------------------------------------------------------
def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    got = t_common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    want = r_common.rms_norm(jnp.asarray(x), jnp.asarray(scale))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    got = t_common.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias))
    want = r_common.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                               jnp.asarray(bias))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    # fp32 inside, cast back to the input dtype
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert t_common.rms_norm(xb, torch.from_numpy(scale)).dtype == torch.bfloat16


@pytest.mark.parametrize("rope_pct", [1.0, 0.25])
@pytest.mark.parametrize("theta", [10_000.0, 100_000.0])
def test_apply_rope_matches_reference(rope_pct, theta):
    """Interleaved pairs (x[0::2], x[1::2]); with rope_pct < 1 only the
    first int(hd * pct) // 2 * 2 dims rotate (stablelm)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 7))
    got = t_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta, rope_pct)
    want = r_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                               rope_pct)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)
    rot = int(32 * rope_pct) // 2 * 2
    assert np.array_equal(_np(got)[..., rot:], x[..., rot:])


@pytest.mark.parametrize("act", ["gelu", "swiglu", "geglu", "relu_sq"])
def test_mlp_apply_matches_reference(act):
    """GELU is jax.nn.gelu's default, the tanh approximation."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    p = {k: rng.normal(size=s).astype(np.float32) / 6 for k, s in
         (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    got = t_common.mlp_apply(torch.from_numpy(x),
                             {k: torch.from_numpy(v) for k, v in p.items()},
                             act)
    want = r_common.mlp_apply(jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in p.items()}, act)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_initialisers_follow_the_generator_and_the_scales():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = t_common.he(g1, (256, 512), torch.float32)
    b = t_common.he(g2, (256, 512), torch.float32)
    assert torch.equal(a, b)
    assert abs(float(a.std()) - 1 / np.sqrt(256)) < 2e-3
    e = t_common.embed_init(g1, 300, 64, torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 0.02) < 1e-3
    assert t_common.dtype_of("bfloat16") == torch.bfloat16


# -- parameters ----------------------------------------------------------------------
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


@pytest.mark.parametrize("arch", PORTED)
def test_init_tree_matches_reference_shapes(arch):
    cfg = t_registry.get(arch).tiny().cfg
    r_params = r_registry.get(arch).tiny().module.init(
        r_registry.get(arch).tiny().cfg, jax.random.PRNGKey(0))
    t_params = t_registry.get(arch).module.init(cfg, 0, device="cpu")
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(r_params).items()}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in t_params.named_parameters()}
    assert got == want
    assert not any(p.requires_grad for p in t_params.parameters())


def test_params_from_jax_round_trips_exactly():
    arch = r_registry.get("starcoder2-3b").tiny()
    tree = jax.tree_util.tree_map(np.asarray,
                                  arch.module.init(arch.cfg,
                                                   jax.random.PRNGKey(1)))
    cfg = t_registry.get("starcoder2-3b").tiny().cfg
    params = params_from_jax(cfg, tree, device="cpu")
    got = dict(params.named_parameters())
    want = _flat(tree)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert np.array_equal(_np(got[name]), np.asarray(value, np.float32)), name
    assert params.layer(1)["attn"]["wq"].data_ptr() == (
        got["layers.attn.wq"][1].data_ptr())
    # bf16 crosses bit-exactly
    bf = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), tree)
    pb = params_from_jax(cfg, bf, device="cpu")
    assert pb.embed.dtype == torch.bfloat16
    assert np.array_equal(_np(pb.embed),
                          np.asarray(bf["embed"]).astype(np.float32))
    with pytest.raises(ValueError, match="lm_head"):
        params_from_jax(dataclasses.replace(cfg, tie_embeddings=True), tree,
                        device="cpu")


def test_init_without_a_card_raises_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = t_registry.get("starcoder2-3b").tiny().cfg
    with pytest.raises(RuntimeError, match="CUDA"):
        t_registry.get("starcoder2-3b").module.init(cfg, 0)


# -- samplers ------------------------------------------------------------------------
def test_samplers():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(6, 50)).astype(np.float32)
    logits[2, [3, 7]] = 9.0  # a tie: the first index wins, as jnp.argmax
    got = t_sampler.sample_greedy(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jnp.argmax(logits, -1)))
    g = torch.Generator().manual_seed(0)
    a = t_sampler.sample_temperature(torch.from_numpy(logits), g, 0.7)
    b = t_sampler.sample_temperature(torch.from_numpy(logits),
                                     torch.Generator().manual_seed(0), 0.7)
    assert torch.equal(a, b) and a.shape == (6,)
    k = t_sampler.sample_topk(torch.from_numpy(logits), g, k=5)
    top5 = np.argsort(-logits, axis=-1)[:, :5]
    assert all(int(k[i]) in top5[i] for i in range(6))
    cold = t_sampler.sample_topk(torch.from_numpy(logits), g, k=5,
                                 temperature=1e-9)
    assert np.array_equal(cold.numpy()[[0, 1, 3]],
                          np.argmax(logits, -1)[[0, 1, 3]])
