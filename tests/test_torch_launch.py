"""Differential tests for the port's pod-lowering tooling on one card:
``launch/{shapes,mesh,shardings,steps,hlo_analysis,dryrun}``, the model
hooks the steps need (the activation policy, ``block_flash``,
``wkv_chunked``, ``moe_mlp_ep``) and ``benchmarks/roofline``, each
against its reference in ``repro``.

The reference's mesh-bound side (``NamedSharding`` over 8 virtual
devices, ``input_specs``, the dry run's ``model_flops`` and
``should_offload_opt``) runs in one subprocess, as
``tests/test_distributed.py`` does; its specs come back as JSON lists.

Tolerances: fp32 on the CPU, the same inputs; outputs agree to 1e-4
(the port's attention and model tests), ``wkv_chunked`` to the
reference test's 1e-4, the expert-parallel MLP to the reference test's
5e-3, and the micro-batched train step's parameter changes to fp32
rounding's 1e-5 (its losses to
``test_sharded_train_step_matches_single_device``'s 5e-3)."""
import dataclasses
import json
import os
import resource
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import roofline as r_roof  # noqa: E402
from repro.launch import hlo_analysis as r_hlo  # noqa: E402
from repro.launch import shapes as r_shapes  # noqa: E402
from repro.launch import shardings as r_sh  # noqa: E402
from repro.launch import steps as r_steps  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro.models import rwkv as r_rwkv  # noqa: E402
from repro.models.common import activation_sharding as r_policy  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro_torch.benchmarks import roofline as t_roof  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.tiers import h100_topology  # noqa: E402
from repro_torch.kernels.wkv6 import ops as wkv_ops  # noqa: E402
from repro_torch.launch import dryrun as t_dry  # noqa: E402
from repro_torch.launch import hlo_analysis as t_hlo  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import shapes as t_shapes  # noqa: E402
from repro_torch.launch import shardings as t_sh  # noqa: E402
from repro_torch.launch import steps as t_steps  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.models import rglru as t_rglru  # noqa: E402
from repro_torch.models import rwkv as t_rwkv  # noqa: E402
from repro_torch.models import transformer as t_transformer  # noqa: E402
from repro_torch.models import whisper as t_whisper  # noqa: E402
from repro_torch.models.common import activation_sharding as t_policy  # noqa: E402
from repro_torch.optim import adamw as t_adamw  # noqa: E402
from repro_torch.tree import flatten, ref_key  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
GIB16 = 16 * 1024**3
SMALL_MESHES = (((2, 4), ("data", "model")),
                ((2, 2, 2), ("pod", "data", "model")))
SPEC_ARCHS = ("starcoder2-3b", "rwkv6-7b", "whisper-large-v3",
              "deepseek-moe-16b", "recurrentgemma-9b")
CELL_SHAPES = (("starcoder2-3b", "train_4k"), ("starcoder2-3b", "prefill_32k"),
               ("whisper-large-v3", "train_4k"), ("internvl2-2b", "prefill_32k"))
SMALL_CELL = ("internvl2-2b", 512, 8, 2)  # test_dryrun_machinery_small_mesh


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _enc(spec) -> list:
    """A spec (``PartitionSpec`` or the port's tuple) as JSON lists."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


def _fp32(arch_id):
    r = r_registry.get(arch_id).tiny()
    t = t_registry.get(arch_id).tiny()
    cfg = dataclasses.replace(r.cfg, param_dtype="float32")
    tcfg = dataclasses.replace(t.cfg, param_dtype="float32")
    return (dataclasses.replace(r, cfg=cfg), dataclasses.replace(t, cfg=tcfg))


def _params(r_arch, t_arch, seed=0):
    tree = jax.tree_util.tree_map(
        np.asarray, r_arch.module.init(r_arch.cfg, jax.random.PRNGKey(seed)))
    return tree, params_from_jax(t_arch.cfg, tree, device="cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the reference's mesh-bound side, in one subprocess -----------------------------
_REFERENCE_SIDE = """
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import sys; sys.path.insert(0, {src!r})
import jax
from repro.launch import shardings as sh, steps
from repro.launch.mesh import make_mesh
from repro.launch.shapes import SHAPES, ShapeSpec
from repro.models import registry

def enc(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]

def specs(tree):
    return {{str(p): enc(s.spec) for p, s in
             jax.tree_util.tree_flatten_with_path(tree)[0]}}

def avals(tree):
    return {{str(p): [list(a.shape), str(a.dtype)] for p, a in
             jax.tree_util.tree_flatten_with_path(tree)[0]}}

out = {{"meshes": {{}}, "cells": {{}}}}
meshes = [make_mesh(s, a) for s, a in {meshes!r}]
for mesh in meshes:
    key = "x".join(map(str, mesh.devices.shape))
    m = out["meshes"][key] = {{"archs": {{}}}}
    m["batch_sharding"] = [enc(sh.batch_sharding(mesh, b, e, f).spec)
                           for b, e, f in ((8, 2, 0), (3, 2, 1), (16, 1, 2))]
    for seq in (False, True):
        pol = sh.activation_policy(mesh, seq_sharded=seq)
        m[f"policy_{{seq}}"] = {{
            k: (enc(v.spec) if hasattr(v, "spec") else
                [dict(v[0].shape), list(v[1])] if k == "_ep" else v)
            for k, v in pol.items()}}
    for arch_id in {spec_archs!r}:
        arch = registry.get(arch_id).tiny()
        cfg = arch.cfg
        pa = steps.abstract_params(arch)
        psh = sh.param_shardings(pa, cfg, mesh)
        a = m["archs"][arch_id] = {{}}
        for z in (False, True):
            osh = sh.opt_state_shardings(psh, pa, zero1=z)
            a[f"mu_{{z}}"] = specs(osh["mu"])
            a[f"step_{{z}}"] = enc(osh["step"].spec)
        cache = jax.eval_shape(lambda: arch.module.init_cache(cfg, 4, 32))
        a["cache"] = specs(sh.cache_shardings(cache, mesh))

mesh = meshes[0]
cells = [(a, "decode_32k") for a in registry.ARCH_IDS] + list({cell_shapes!r})
for arch_id, shape_name in cells:
    arch = registry.get(arch_id)
    cs = steps.input_specs(arch, SHAPES[shape_name], mesh)
    c = out["cells"][f"{{arch_id}}/{{shape_name}}"] = {{
        "param_sh": specs(cs.param_sh), "self_cache_bytes":
            steps.self_cache_bytes(arch.cfg, SHAPES[shape_name])}}
    for name, sh_name in (("batch", "batch_sh"), ("opt_state", "opt_sh"),
                          ("cache", "cache_sh")):
        if getattr(cs, name) is not None:
            c[name] = avals(getattr(cs, name))
            c[name + "_sh"] = specs(getattr(cs, sh_name))
    if cs.tokens is not None:
        c["tokens"] = [list(cs.tokens.shape), str(cs.tokens.dtype)]
        c["tokens_sh"] = enc(cs.tokens_sh.spec)

from repro.launch import dryrun  # sets XLA_FLAGS: the backend is up already
arch_id, seq, batch, n_micro = {small_cell!r}
cfg = registry.get(arch_id).cfg
shape = ShapeSpec("train_tiny", seq=seq, batch=batch, kind="train")
out["model_flops"] = dryrun.model_flops(cfg, shape)
out["offload"] = {{a: [dryrun.should_offload_opt(registry.get(a).cfg, n)
                       for n in (1, 8, 256)] for a in registry.ARCH_IDS}}
print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_side():
    script = _REFERENCE_SIDE.format(
        src=str(ROOT / "src"), meshes=SMALL_MESHES, spec_archs=SPEC_ARCHS,
        cell_shapes=CELL_SHAPES, small_cell=SMALL_CELL)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=400, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    line = next(x for x in res.stdout.splitlines() if x.startswith("JSON"))
    return json.loads(line[4:])


# -- shapes and meshes -------------------------------------------------------------
def test_shapes_and_cells_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in t_shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in r_shapes.SHAPES.items()}
    t_cells = t_shapes.cells({a: t_registry.get_config(a)
                              for a in t_registry.ARCH_IDS})
    r_cells = r_shapes.cells({a: r_registry.get(a).cfg
                              for a in r_registry.ARCH_IDS})
    assert [(a, s.name, ok, why) for a, s, ok, why in t_cells] == \
        [(a, s.name, ok, why) for a, s, ok, why in r_cells]
    assert sum(not ok for _, _, ok, _ in t_cells) == 8  # long_500k skips


def test_mesh_is_a_record_of_the_references():
    for multi in (False, True):
        m = t_mesh.make_production_mesh(multi_pod=multi)
        assert m.size == t_mesh.chips(m) == (512 if multi else 256)
        assert t_mesh.dp_axes(m) == (("pod", "data") if multi else ("data",))
        assert m.shape == ({"pod": 2, "data": 16, "model": 16} if multi
                           else {"data": 16, "model": 16})
    small = t_mesh.make_mesh((2, 4), ("data", "model"))
    assert t_mesh.dp_size(small) == 2
    with t_mesh.mesh_context(small) as entered:
        assert entered is small
    with pytest.raises(ValueError):
        t_mesh.make_mesh((2, 4), ("data",))


# -- sharding specs ----------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_specs_match_reference(multi_pod):
    """Every leaf of every config at full size, ``for_arch`` at 16 GiB;
    both sides on abstract trees (``jax.eval_shape``, ``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t_m = t_mesh.make_production_mesh(multi_pod=multi_pod)
    r_m = SimpleNamespace(axis_names=tuple(t_m.axis_names), shape=t_m.shape)
    n_fsdp = 0
    for arch_id in r_registry.ARCH_IDS:
        arch = r_registry.get(arch_id)
        rcfg = r_sh.ShardingConfig.for_arch(arch.cfg)
        tcfg = t_sh.ShardingConfig.for_arch(t_registry.get_config(arch_id),
                                            hbm_bytes=GIB16)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
        n_fsdp += tcfg.fsdp
        want = {str(p): _enc(r_sh.param_spec(p, leaf, arch.cfg, r_m, rcfg))
                for p, leaf in jax.tree_util.tree_flatten_with_path(
                    r_steps.abstract_params(arch))[0]}
        fake = t_steps.abstract_params(t_registry.get(arch_id),
                                       FakeTensorMode())
        got = {k: _enc(v) for k, v in t_sh.param_shardings(
            fake, t_registry.get_config(arch_id), t_m, tcfg).items()}
        assert got == want, arch_id
    assert n_fsdp > 0  # the FSDP branch is exercised


def test_sharding_specs_match_reference_on_small_meshes(reference_side):
    from torch._subclasses.fake_tensor import FakeTensorMode
    for shape, axes in SMALL_MESHES:
        mesh = t_mesh.make_mesh(shape, axes)
        ref = reference_side["meshes"]["x".join(map(str, shape))]
        assert [_enc(t_sh.batch_sharding(mesh, b, e, f))
                for b, e, f in ((8, 2, 0), (3, 2, 1), (16, 1, 2))] == \
            ref["batch_sharding"]
        for seq in (False, True):
            pol = t_sh.activation_policy(mesh, seq_sharded=seq)
            got = {k: ([v[0].shape, list(v[1])] if k == "_ep" else
                       _enc(v) if isinstance(v, tuple) else v)
                   for k, v in pol.items()}
            assert got == ref[f"policy_{seq}"]
        for arch_id in SPEC_ARCHS:
            arch = t_registry.get(arch_id).tiny()
            mode = FakeTensorMode()
            pa = t_steps.abstract_params(arch, mode)
            psh = t_sh.param_shardings(pa, arch.cfg, mesh,
                                       t_sh.ShardingConfig.for_arch(
                                           arch.cfg, hbm_bytes=GIB16))
            want = ref["archs"][arch_id]
            for z in (False, True):
                osh = t_sh.opt_state_shardings(psh, pa, zero1=z, mesh=mesh)
                assert {k: _enc(v) for k, v in osh["mu"].items()} == \
                    want[f"mu_{z}"], (arch_id, z)
                assert osh["nu"] == osh["mu"]
                assert _enc(osh["step"]) == want[f"step_{z}"]
            with mode:
                cache = arch.module.init_cache(arch.cfg, 4, 32, device="cpu")
            assert {k: _enc(v) for k, v in
                    t_sh.cache_shardings(cache, mesh).items()} == \
                want["cache"], arch_id


def test_input_specs_and_cache_bytes_match_reference(reference_side):
    """``input_specs`` on the (2, 4) mesh at 16 GiB: every abstract leaf's
    shape and dtype and every spec, including the fp8 cache rule, for
    each config's decode_32k cell and a few train and prefill cells."""
    mesh = t_mesh.make_mesh(*SMALL_MESHES[0])
    n_fp8 = 0
    for name, ref in reference_side["cells"].items():
        arch_id, shape_name = name.split("/")
        shape = t_shapes.SHAPES[shape_name]
        arch = t_registry.get(arch_id)
        assert t_steps.self_cache_bytes(arch.cfg, shape) == \
            ref["self_cache_bytes"]
        cs = t_steps.input_specs(arch, shape, mesh, hbm_bytes=GIB16)
        assert {k: _enc(v) for k, v in cs.param_sh.items()} == ref["param_sh"]
        for part in ("batch", "opt_state", "cache"):
            tree = getattr(cs, part)
            assert (tree is not None) == (part in ref), (name, part)
            if tree is None:
                continue
            got = {ref_key(p): [list(t.shape), str(t.dtype).split(".")[-1]]
                   for p, t in flatten(tree)}
            assert got == ref[part], (name, part)
        if cs.batch is not None:
            assert {ref_key((k,)): _enc(v) for k, v in cs.batch_sh.items()} \
                == ref["batch_sh"]
        if cs.opt_state is not None:
            # the port keys a moment's spec by its parameter's path
            for moment in ("mu", "nu"):
                got = {ref_key((moment,) + p): _enc(
                    cs.opt_sh[moment][ref_key(p)])
                    for p, _ in flatten(cs.params)}
                want = {k: v for k, v in ref["opt_state_sh"].items()
                        if k.startswith(f"(DictKey(key='{moment}'), ")}
                assert got == want, name
            assert _enc(cs.opt_sh["step"]) == \
                ref["opt_state_sh"]["(DictKey(key='step'),)"]
        if cs.cache is not None:
            assert {k: _enc(v) for k, v in cs.cache_sh.items()} == \
                ref["cache_sh"], name
            assert [list(cs.tokens.shape), str(cs.tokens.dtype).split(".")[-1]
                    ] == ref["tokens"]
            assert _enc(cs.tokens_sh) == ref["tokens_sh"]
            n_fp8 += cs.cache["k"].dtype == torch.float8_e4m3fn \
                if "k" in cs.cache else 0
    assert n_fp8 > 0  # the fp8 rule fires somewhere


# -- the model hooks ---------------------------------------------------------------
class Recording(dict):
    """A policy that records every name a model looks up in it."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.names = set()

    def __contains__(self, key):
        self.names.add(key)
        return super().__contains__(key)

    def get(self, key, default=None):
        self.names.add(key)
        return super().get(key, default)

    def __getitem__(self, key):
        self.names.add(key)
        return super().__getitem__(key)


@pytest.mark.parametrize("window", [0, 48])
def test_block_flash_matches_reference(window, monkeypatch):
    """S = 256 under ``_flash`` with KV chunks of 64 and query chunks of
    32, causal, with and without a window: the port's online softmax
    against the reference's, and against the exact path."""
    rng = np.random.default_rng(3)
    B, S, D, H, K, hd = 2, 256, 32, 4, 2, 8
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    p = {n: (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)
         for n, shape in (("wq", (D, H * hd)), ("wk", (D, K * hd)),
                          ("wv", (D, K * hd)), ("wo", (H * hd, D)))}
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    kw = dict(n_heads=H, n_kv_heads=K, head_dim=hd, causal=True,
              window=window)
    pol = {"_flash": True, "_kv_chunk": 64, "_q_chunk": 32}
    with r_policy(pol):
        want = r_attn.attention(jnp.asarray(x), {k: jnp.asarray(v) for k, v
                                                 in p.items()},
                                positions=jnp.asarray(pos), **kw)
    calls = []
    flash = t_attn.block_flash
    monkeypatch.setattr(t_attn, "block_flash",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    tp = {k: _t(v) for k, v in p.items()}
    with t_policy(pol):
        got = t_attn.attention(_t(x), tp, positions=_t(pos), **kw)
    assert len(calls) == S // 32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    exact = t_attn.attention(_t(x), tp, positions=_t(pos), **kw)
    np.testing.assert_allclose(_np(got), _np(exact), **TOL)


def _wkv_inputs():
    """``test_wkv_chunked_matches_exact``'s inputs."""
    key = jax.random.PRNGKey(0)
    B, T, H, hd = 2, 64, 2, 16
    mk = lambda i: jax.random.normal(jax.random.fold_in(key, i),  # noqa: E731
                                     (B, T, H, hd))
    r, k, v = mk(0) * 0.5, mk(1) * 0.5, mk(2)
    w = jnp.exp(-jnp.exp(jax.random.uniform(key, (B, T, H, hd),
                                            minval=-8.0, maxval=1.5)))
    u = mk(4)[0, 0] * 0.1
    s0 = jax.random.normal(jax.random.fold_in(key, 9), (B, H, hd, hd)) * 0.1
    return r, k, v, w, u, s0


def test_wkv_chunked_matches_reference_and_the_plain_recurrence():
    r, k, v, w, u, s0 = _wkv_inputs()
    y_r, s_r = r_rwkv.wkv_chunked(r, k, v, w, u, s0, chunk=16)
    args = [_t(a) for a in (r, k, v, w, u, s0)]
    y_c, s_c = t_rwkv.wkv_chunked(*args, chunk=16)
    np.testing.assert_allclose(_np(y_c), _np(y_r), atol=1e-4)
    np.testing.assert_allclose(_np(s_c), _np(s_r), atol=1e-4)
    y_p, s_p = wkv_ops.wkv6(*args)
    np.testing.assert_allclose(_np(y_c), _np(y_p), atol=1e-4)
    np.testing.assert_allclose(_np(s_c), _np(s_p), atol=1e-4)
    out = torch.empty_like(s_c)
    y_o, s_o = t_rwkv.wkv_chunked(*args, chunk=16, state_out=out)
    assert s_o is out and torch.equal(out, s_c) and torch.equal(y_o, y_c)
    with pytest.raises(ValueError):
        t_rwkv.wkv_chunked(*[a[:, :20] if a.dim() == 4 and a.shape[1] == 64
                             else a for a in args], chunk=16)


def test_rwkv_forward_under_the_chunked_policy(monkeypatch):
    """``time_mix`` takes ``wkv_chunked`` under ``_wkv_chunked`` (T = 32)
    and the ``wkv6`` wrapper otherwise; both forwards equal the
    reference's under the same policy."""
    r_arch, t_arch = _fp32("rwkv6-7b")
    tree, params = _params(r_arch, t_arch)
    toks = np.random.default_rng(4).integers(0, 200, size=(2, 32)) \
        .astype(np.int32)
    pol = {"_wkv_chunked": True}
    with r_policy(pol):
        want = r_rwkv.forward(r_arch.cfg, jax.tree_util.tree_map(
            jnp.asarray, tree), jnp.asarray(toks))
    launches = []
    plain = wkv_ops.wkv6
    monkeypatch.setattr(wkv_ops, "wkv6",
                        lambda *a, **k: launches.append(1) or plain(*a, **k))
    with t_policy(pol):
        got = t_rwkv.forward(t_arch.cfg, params, _t(toks))
    assert launches == []
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    exact = t_rwkv.forward(t_arch.cfg, params, _t(toks))
    assert len(launches) == t_arch.cfg.n_layers
    np.testing.assert_allclose(_np(exact), _np(want), **TOL)


def test_moe_mlp_ep_on_a_group_of_one():
    """One rank: the expert-parallel MLP is the single-device one (the
    analogue of ``test_ep_shard_map_matches_reference``, error < 5e-3),
    and ``routed_mlp`` takes it when the policy holds the group."""
    import torch.distributed as dist
    r_arch, t_arch = _fp32("deepseek-moe-16b")
    _, params = _params(r_arch, t_arch)
    lp = params.unit(0)["moe"]
    cfg = t_arch.cfg
    x = _t(np.random.default_rng(6).normal(size=(32, cfg.d_model))
           .astype(np.float32))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        group = dist.new_group([0])
        want, aux_w = t_moe.moe_mlp(x, lp, cfg.moe, cfg.act)
        got, aux_g = t_moe.moe_mlp_ep(x, lp, cfg.moe, cfg.act, group)
        assert float((got - want).abs().max()) < 5e-3
        calls = []
        ep = t_moe.moe_mlp_ep
        t_moe.moe_mlp_ep = lambda *a: calls.append(1) or ep(*a)
        try:
            with t_policy({"_ep": group}):
                routed, _ = t_moe.routed_mlp(x, lp, cfg.moe, cfg.act)
        finally:
            t_moe.moe_mlp_ep = ep
        assert calls == [1] and torch.equal(routed, got)
    finally:
        dist.destroy_process_group()
    for k in ("lb_loss", "z_loss", "dropped"):
        assert float(aux_g[k]) == pytest.approx(float(aux_w[k]), rel=1e-5)
    # the group-of-one capacity rounds to 4, the single-device one to 8:
    # both keep every pair at this size
    assert torch.equal(aux_g["expert_counts"], aux_w["expert_counts"])


def _ep_rank(rank: int, port: int, tree_path: str, toks, out_path: str):
    """One rank of a gloo group of two: the tiny deepseek-moe-16b forward
    with the group in the policy (run by ``torch.multiprocessing``)."""
    import pickle

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        with open(tree_path, "rb") as f:
            tree = pickle.load(f)
        _, t_arch = _fp32("deepseek-moe-16b")
        params = params_from_jax(t_arch.cfg, tree, device="cpu")
        with t_policy({"_ep": dist.group.WORLD}):
            logits = t_moe.forward(t_arch.cfg, params, torch.from_numpy(toks))
        np.save(out_path.format(rank), logits.numpy())
    finally:
        dist.destroy_process_group()


def test_moe_mlp_ep_on_a_spawned_group_of_two(tmp_path):
    """Two ranks, each its half of the tokens and of the experts, one
    all-to-all each way: the forward equals the single-process one and
    the reference's (``test_ep_shard_map_matches_reference``'s bar)."""
    import pickle

    import torch.multiprocessing as mp
    r_arch, t_arch = _fp32("deepseek-moe-16b")
    tree, params = _params(r_arch, t_arch)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (8, 16), 0,
                                         200)).astype(np.int32)
    want = r_arch.module.forward(r_arch.cfg, jax.tree_util.tree_map(
        jnp.asarray, tree), jnp.asarray(toks))
    single = t_moe.forward(t_arch.cfg, params, _t(toks))
    tree_path = str(tmp_path / "tree.pkl")
    with open(tree_path, "wb") as f:
        pickle.dump(tree, f)
    out = str(tmp_path / "logits{}.npy")
    mp.start_processes(_ep_rank, args=(_free_port(), tree_path, toks, out),
                       nprocs=2, join=True, start_method="spawn")
    for rank in range(2):
        got = np.load(out.format(rank))
        assert float(np.abs(got - _np(single)).max()) < 5e-3
        assert float(np.abs(got - _np(want)).max()) < 5e-3


# -- steps -------------------------------------------------------------------------
def _deltas(params, first) -> dict:
    """Each leaf's change from ``first``, as fp32 numpy."""
    return {k: _np(v) - _np(first[k]) for k, v in dict(
        params.named_parameters()).items()}


def test_train_step_micro_batches_match_one_step_and_the_reference():
    """starcoder2-3b ``.tiny()`` in fp32, batch 8 x 32, two AdamW steps
    on two batches at lr 1e-3 (each step moves a leaf by ~1e-3).  After
    each step, each leaf's change from the start is held to the
    reference's ``make_train_step`` at the same ``n_micro`` from the
    same weights, and ``n_micro=2``'s to ``n_micro=1``'s, at fp32
    rounding's limit (atol 1e-5, rtol 1e-3); the losses within 5e-3
    and the gradient norms (which see how the accumulators are scaled)
    within 1e-4 relative."""
    r_arch, t_arch = _fp32("starcoder2-3b")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 200, size=(8, 32)).astype(np.int32)
               for _ in range(2)]
    opt = dict(lr=1e-3)
    delta_tol = dict(atol=1e-5, rtol=1e-3)
    out = {}
    for n_micro in (1, 2):
        tree, params = _params(r_arch, t_arch)
        first = {k: v.detach().clone()
                 for k, v in params.named_parameters()}
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        r_state, t_state = r_adamw.init_state(jp), t_adamw.init_state(params)
        r_fn = jax.jit(r_steps.make_train_step(
            r_arch, r_adamw.AdamWConfig(**opt), n_micro=n_micro))
        t_fn = t_steps.make_train_step(t_arch, t_adamw.AdamWConfig(**opt),
                                       n_micro=n_micro)
        for step, toks in enumerate(batches):
            jp, r_state, rm = r_fn(jp, r_state, {
                "tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
            params, t_state, tm = t_fn(params, t_state, {
                "tokens": _t(toks), "labels": _t(toks)})
            assert abs(float(tm["loss"]) - float(rm["loss"])) < 5e-3
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(rm["grad_norm"]), rtol=1e-4)
            got = _deltas(params, first)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
                name = ".".join(p.key for p in path)
                want = np.asarray(leaf) - _np(first[name])
                assert np.abs(want).max() > 1e-4, name  # the step moved it
                np.testing.assert_allclose(got[name], want, **delta_tol,
                                           err_msg=f"{name}, step {step}")
            out[n_micro, step] = (float(tm["loss"]),
                                  float(tm["grad_norm"]), got)
    for step in range(len(batches)):
        (l1, n1, d1), (l2, n2, d2) = out[1, step], out[2, step]
        assert abs(l1 - l2) < 5e-3
        np.testing.assert_allclose(n2, n1, rtol=1e-4)
        for k, v in d1.items():
            np.testing.assert_allclose(d2[k], v, **delta_tol,
                                       err_msg=f"{k}, step {step}")
    grads, metrics = t_steps.make_train_step(
        t_arch, t_adamw.AdamWConfig(), n_micro=2, return_grads=True)(
        params, {"tokens": _t(batches[0]), "labels": _t(batches[0])})
    assert set(grads) == set(out[1, 0][2]) and all(
        g.dtype == torch.float32 for g in grads.values())


FAMILY_ARCHS = ("starcoder2-3b", "internvl2-2b", "deepseek-moe-16b",
                "rwkv6-7b", "recurrentgemma-9b", "whisper-large-v3")
# the port's modules that call ``maybe_shard``
FAMILY_MODULES = (t_attn, t_moe, t_rwkv, t_rglru, t_transformer, t_whisper)


@pytest.mark.parametrize("arch_id", FAMILY_ARCHS)
def test_prefill_and_serve_steps_match_reference(arch_id, monkeypatch):
    """One tiny config a family, fp32: ``make_prefill_step`` under a
    policy of the switches (query and KV chunks, flash, chunked WKV) and
    ``make_serve_step`` from a fresh cache, against the reference's; the
    prefill reads the reference's switches and calls ``maybe_shard`` at
    the activation names the reference looks up."""
    r_arch, t_arch = _fp32(arch_id)
    cfg = t_arch.cfg
    tree, params = _params(r_arch, t_arch)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    rng = np.random.default_rng(7)
    B, S = 2, 32
    batch = {"tokens": rng.integers(0, 200, size=(B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.vision.n_prefix_tokens, cfg.d_model)) \
            .astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(
            size=(B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    switches = {"_q_chunk": 8, "_flash": True, "_kv_chunk": 16,
                "_wkv_chunked": True}
    r_pol, t_pol = Recording(switches), Recording(switches)

    def recording_shard(x, name):
        if t_common.current_policy() is t_pol:
            t_pol.names.add(name)
        return x
    for mod in FAMILY_MODULES:
        monkeypatch.setattr(mod, "maybe_shard", recording_shard)
    want = r_steps.make_prefill_step(r_arch, act_policy=r_pol)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = t_steps.make_prefill_step(t_arch, act_policy=t_pol)(
        params, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert t_pol.names == r_pol.names, (t_pol.names ^ r_pol.names)

    tok = batch["tokens"][:, 0]
    r_cache = r_arch.module.init_cache(r_arch.cfg, B, S)
    t_cache = t_arch.module.init_cache(cfg, B, S, device="cpu")
    r_logits, r_cache = r_steps.make_serve_step(r_arch)(
        jp, r_cache, jnp.asarray(tok))
    t_logits, t_cache = t_steps.make_serve_step(t_arch)(
        params, t_cache, _t(tok))
    np.testing.assert_allclose(_np(t_logits), _np(r_logits), **TOL)
    assert np.array_equal(_np(t_cache["len"]), _np(r_cache["len"]))


# -- hlo_analysis and the dry run --------------------------------------------------
_COLLECTIVES_HLO = """\
HloModule m

%add (a: f32[], b: f32[]) -> f32[] {
  %a = f32[] parameter(0)
  %b = f32[] parameter(1)
  ROOT %s = f32[] add(f32[] %a, f32[] %b)
}

ENTRY %main (p0: f32[64,32], p1: f32[32,16]) -> f32[64,16] {
  %p0 = f32[64,32]{1,0} parameter(0)
  %p1 = f32[32,16]{1,0} parameter(1)
  %d = f32[64,16]{1,0} dot(f32[64,32]{1,0} %p0, f32[32,16]{1,0} %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[64,16]{1,0} all-reduce(f32[64,16]{1,0} %d), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %ag = f32[128,16]{1,0} all-gather(f32[64,16]{1,0} %ar), replica_groups=[2,256]<=[512], dimensions={0}
  ROOT %cp = f32[64,16]{1,0} collective-permute(f32[64,16]{1,0} %ar), source_target_pairs={{0,1},{1,0}}
}
"""


def test_hlo_analysis_is_the_references():
    """The copied analyzer on a compiled scanned JAX program and on a
    hand-written collective snippet, field for field, and the replica
    groups of ``test_collective_permute_and_groups_decode``."""
    def prog(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        return jax.lax.scan(body, x, ws)[0].sum()
    text = jax.jit(prog).lower(jnp.ones((8, 16)), jnp.ones((4, 16, 16))) \
        .compile().as_text()
    for hlo, n in ((text, 1), (_COLLECTIVES_HLO, 512)):
        want = r_hlo.analyze(hlo, n_devices=n)
        got = t_hlo.analyze(hlo, n_devices=n)
        assert dataclasses.asdict(got) == dict(dataclasses.asdict(want),
                                               peak_bytes=0.0)
        assert got.collective_counts() == want.collective_counts()
        for link in ("ici", "dcn", None):
            assert got.collective_bytes(link) == want.collective_bytes(link)
    assert r_hlo.analyze(text, n_devices=1).flops == 4 * 2 * 8 * 16 * 16
    # the permute has no replica groups: one group of all 512 devices,
    # two pods, so an ICI and a DCN record
    assert t_hlo.analyze(_COLLECTIVES_HLO, n_devices=512).collective_counts() \
        == {"all-reduce": 1, "all-gather": 1, "collective-permute": 2}
    g = t_hlo.decode_replica_groups("replica_groups=[32,16]<=[512]", 512)
    assert len(g) == 32 and len(g[0]) == 16 and g[0] == list(range(16))
    g = t_hlo.decode_replica_groups("replica_groups=[16,32]<=[32,16]T(1,0)",
                                    512)
    assert len(g) == 16 and len(g[0]) == 32 and g[0][:3] == [0, 16, 32]
    assert t_hlo.decode_replica_groups("replica_groups={{0,1},{2,3}}", 4) \
        == [[0, 1], [2, 3]]


def test_costs_of_counts_a_known_chain_exactly():
    M, K, N = 8, 16, 4
    a, b = torch.randn(M, K), torch.randn(K, N)
    costs = t_hlo.costs_of(lambda x, y: torch.relu(x @ y).t().sum(), a, b)
    assert costs.flops == 2 * M * N * K
    # mm reads both operands and writes its result; relu reads and writes
    # (M, N); the transpose is a view; the sum reads (N, M), writes one
    assert costs.hbm_bytes == 4 * (M * K + K * N + M * N) + 4 * 2 * M * N \
        + 4 * (M * N + 1)
    assert costs.collectives == [] and costs.n_devices == 1
    assert costs.peak_bytes == 4 * (2 * M * N)  # mm's and relu's results


def test_lower_cell_traces_the_small_cell_without_allocating(reference_side):
    arch_id, seq, batch, n_micro = SMALL_CELL
    shape = t_shapes.ShapeSpec("train_tiny", seq=seq, batch=batch,
                               kind="train")
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    rec = t_dry.lower_cell(arch_id, shape, n_micro=n_micro, hbm_bytes=GIB16)
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss0) * 1024
    assert grown < 1 << 30 < rec["bytes"]["params"]  # 3.8 GB never made
    assert rec["hlo"]["flops_per_device"] > 0
    assert rec["memory"]["peak_per_device"] > rec["memory"][
        "activation_peak_bytes"] > 0
    assert rec["hlo"]["collective_counts"] == {}
    assert rec["model_flops_total"] == reference_side["model_flops"]
    cfg = t_registry.get_config(arch_id)
    assert rec["offload_opt"] == reference_side["offload"][arch_id][0]
    for a in t_registry.ARCH_IDS:
        assert [t_dry.should_offload_opt(t_registry.get_config(a), n, GIB16)
                for n in (1, 8, 256)] == reference_side["offload"][a]
    assert t_dry.model_flops(cfg, shape) == reference_side["model_flops"]


@pytest.mark.parametrize("arch_id", ["starcoder2-3b", "deepseek-moe-16b",
                                     "recurrentgemma-9b", "whisper-large-v3"])
def test_prefill_depth_extrapolation_is_exact(arch_id):
    """A prefill traced at one and two repeated units and extrapolated
    gives the FLOPs and bytes of the whole model's trace, and its peak
    to 0.1% (flash and chunked WKV on, as the dry run runs them)."""
    arch = t_registry.get(arch_id).tiny()
    units, cfg_at = t_dry.depth_units(arch.cfg)
    deep = dataclasses.replace(arch, cfg=cfg_at(5))
    units, cfg_at = t_dry.depth_units(deep.cfg)
    assert units == 5
    shape = t_shapes.ShapeSpec("p", 64, 2, "prefill")
    scfg = t_sh.ShardingConfig.for_arch(deep.cfg, GIB16)
    pol = dict(t_sh.activation_policy(t_dry.CARD_MESH), _kv_chunk=16,
               _q_chunk=16, _wkv_chunked=True)

    def costs(d):
        return t_dry.step_costs(dataclasses.replace(deep, cfg=cfg_at(d)),
                                shape, scfg, pol, 0, False, GIB16)
    got = t_dry._extrapolate(costs(1), costs(2), units)
    want = costs(5)
    assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
    # within a few scalars: the MoE units' aux terms are kept to the end
    assert got.peak_bytes == pytest.approx(want.peak_bytes, rel=1e-3)


def test_roofline_uses_the_cards_peaks(tmp_path, monkeypatch):
    """The terms divide by 989 TFLOP/s, the fitted HBM and pinned rates
    and no collective; the rows and table keep the reference's format
    (the reference's module with the card's constants gives the same)."""
    topo = h100_topology()
    assert (t_roof.PEAK_FLOPS, t_roof.HBM_BW, t_roof.TIER_BW) == (
        989e12, topo.fast.load_bw, topo.slow.load_bw)
    assert t_roof.HBM_BW == pytest.approx(3.107e12, rel=1e-3)
    assert t_roof.TIER_BW == pytest.approx(31.28e9, rel=1e-3)
    base = {"arch": "a", "chips": 1, "n_micro": 4, "params": 1e9,
            "model_flops_total": 3e15,
            "hlo": {"flops_per_device": 5e15, "hbm_bytes_per_device": 2e12,
                    "collective_counts": {}, "ici_bytes_per_device": 0,
                    "dcn_bytes_per_device": 0}}
    recs = [dict(base, shape="fused"),
            dict(base, shape="offload", offload_micro_step=True,
                 offload_traffic_bytes_per_step_per_chip=26e9,
                 migration_bytes_per_step_per_chip=1e8),
            {"arch": "a", "shape": "skip", "skipped": "why"},
            {"arch": "a", "shape": "bad", "error": "E"}]
    t = t_roof.terms(recs[0])
    assert t["compute_s"] == 5e15 / 989e12 and t["collective_s"] == 0.0
    assert t["memory_s"] == 2e12 / topo.fast.load_bw and t["tier_s"] == 0.0
    assert t_roof.terms(recs[1])["tier_s"] == \
        (26e9 + 1e8 + 1e9 * 2 * 4) / topo.slow.load_bw
    for name, value in (("PEAK_FLOPS", 989e12), ("HBM_BW", topo.fast.load_bw),
                        ("PCIE_BW", topo.slow.load_bw)):
        monkeypatch.setattr(r_roof, name, value)
    assert t_roof.csv_rows(recs) == r_roof.csv_rows(recs)
    assert t_roof.table(recs) == r_roof.table(recs)
    (tmp_path / f"x__fused__{t_dry.MESH_TAG}.json").write_text(
        json.dumps(recs[0]))
    assert t_roof.load_records(str(tmp_path)) == [recs[0]]
