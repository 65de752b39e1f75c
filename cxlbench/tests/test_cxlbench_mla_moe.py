"""The DeepSeek-V2 cell: the port's model against the plain reference on
the CPU (logits, loss, every leaf's gradient), the reference's AdamW, the
fp8 control and the planted faults against the limits, the program's
spans, the readers of its per-layer metrics on hand-made traces, and a
broken program step not correct."""
from __future__ import annotations

import json
import math

import pytest

torch = pytest.importorskip("torch")

import repro_torch.models.moe as moe  # noqa: E402
from checkout import ROOT, load_cut  # noqa: E402
from cxlbench import devtrace, traffic, weights  # noqa: E402
from cxlbench.common import load_json, load_piece  # noqa: E402
from cxlbench.reference import dense_decoder  # noqa: E402
from cxlbench.reference import mla_moe_decoder as ref  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

CELL = "dsv2-lite-train-fused-4x4096"
CPU = torch.device("cpu")
FULL = load_json(ROOT / "cxlbench/configs/deepseek-v2-lite-ep8.json")
#: the CPU tests' cut of the configuration, whole enough to run alone
TINY = {**FULL, **load_cut(ROOT, "configs", "deepseek-v2-lite-ep8")}
TRAFFIC = {**load_json(ROOT / "cxlbench/traffic/train-4x4096-fused.json"),
           **load_cut(ROOT, "traffic", "train-4x4096-fused")}
DRIVER = load_piece("drivers", "moe_train_step")
MFU = load_piece("metrics", "train_mfu.dsv2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these shapes are tiny, and beside other test
    processes on the same cores more threads only wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(cfg: dict, seed: int):
    tree = DRIVER._nest(weights_by_name(cfg, seed))
    return DRIVER.arch_config(cfg), moe.MoEParams(
        tree["embed"], tree["head_dense"], tree["units"], tree["final_norm"],
        tree["lm_head"])


def weights_by_name(cfg: dict, seed: int) -> dict:
    return {leaf.name: weights.make_leaf(leaf, i, seed, CPU)
            for i, leaf in enumerate(ref.leaves(cfg))}


def test_the_configuration_holds_the_published_numbers_and_its_share():
    assert FULL["n_routed_experts"] == 8 and FULL["reduced"] == [
        "n_routed_experts"]
    assert FULL["published"]["n_routed_experts"] == 64
    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next(c for c in bench["configs"]
                 if c["name"] == "deepseek-v2-lite-ep8")
    assert entry["reduced"] == FULL["reduced"]
    n = sum(math.prod(leaf.shape) for leaf in ref.leaves(FULL))
    assert n == FULL["parameters"] == 3_110_989_312
    acfg = DRIVER.arch_config(FULL)
    norms = 27 * (2 * 2048 + 512) + 2048
    assert acfg.param_count() + norms == n
    assert acfg.moe.n_experts == 64 and list(acfg.moe.held) == list(range(8))
    assert not acfg.moe.norm_topk and acfg.moe.seq_aux_alpha == 1e-3


def test_the_port_follows_the_reference_on_the_cpu():
    """Logits, loss and every leaf's gradient of the same weights and
    tokens in float32.  Limits: 1e-5 on logits and loss (sums in another
    order); gradients 1e-3 relative to each leaf's largest element, as the
    dense cell's test (the held experts' sums and the seq-wise counts
    run in another order)."""
    acfg, params = _port(TINY, 5)
    b = traffic.token_batch(5, 0, batch=2, seq=16, vocab=TINY["vocab_size"],
                            device=CPU)
    loss, grads = moe.loss_and_grad(acfg, params, b, remat=True)
    w = {k: v.float().requires_grad_(True)
         for k, v in weights_by_name(TINY, 5).items()}
    model = ref.Decoder(TINY, w)
    want = model.loss(b["tokens"], b["labels"])
    want_g = dict(zip(w, torch.autograd.grad(want, list(w.values()))))
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-5)
    with torch.no_grad():
        torch.testing.assert_close(moe.forward(acfg, params, b["tokens"]),
                                   model.logits(b["tokens"]), rtol=1e-5,
                                   atol=1e-5)
    assert set(grads) == set(want_g)
    for k, g in grads.items():
        scale = float(want_g[k].abs().max())
        torch.testing.assert_close(g, want_g[k], rtol=1e-3,
                                   atol=1e-3 * scale, msg=k)


def test_one_adamw_step_of_the_reference_is_the_ports():
    """The reference's AdamW (its own copy of the dense reference's) and
    ``adamw.apply`` move every leaf alike from the same gradients."""
    one = dict(TRAFFIC, checked_steps=1)
    out = ref.train_readings(TINY, one, 3, CPU, keep_grads=True)
    acfg, params = _port(TINY, 3)
    state = adamw.init_state(params)
    cfg = adamw.AdamWConfig(lr=one["lr"], schedule=None)
    adamw.apply(cfg, params, out["first_grads"], state)
    got = dict(params.named_parameters())
    for i, leaf in enumerate(ref.leaves(TINY)):
        start = weights.make_leaf(leaf, i, 3, CPU)
        change = math.sqrt(dense_decoder.gap_sq_norm(got[leaf.name], start))
        assert change == pytest.approx(out["change_norms"][leaf.name],
                                       rel=1e-4, abs=1e-9), leaf.name


@pytest.mark.parametrize("kw", [{"precision": "fp8"},
                                *({"fault": f} for f in ref.FAULTS)],
                         ids=["fp8", *ref.FAULTS])
def test_the_control_and_the_faults_fail_the_limits(kw):
    got = ref.train_readings(TINY, TRAFFIC, 5, CPU, keep_grads=True, **kw)
    want = ref.train_readings(TINY, TRAFFIC, 5, CPU,
                              against=got.pop("first_grads"))
    gaps = dense_decoder.compare(got, want)
    assert any(v > FULL["limits"][k] for k, v in gaps.items()), (kw, gaps)


def test_a_sound_reference_reads_zero_against_itself():
    got = ref.train_readings(TINY, TRAFFIC, 9, CPU, keep_grads=True)
    want = ref.train_readings(TINY, TRAFFIC, 9, CPU,
                              against=got.pop("first_grads"))
    assert all(v == 0 for v in dense_decoder.compare(got, want).values())


def test_the_program_marks_its_layers_for_the_profiler():
    """Each MoE layer's route, dispatch, experts and combine and each
    layer's latent attention are spans, in the forward and again in the
    recompute."""
    acfg, params = _port(TINY, 2)
    b = traffic.token_batch(2, 0, batch=2, seq=16, vocab=TINY["vocab_size"],
                            device=CPU)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        moe.loss_and_grad(acfg, params, b, remat=True)
    names = [e.name for e in prof.events()]
    layers, units = TINY["num_hidden_layers"], TINY["num_hidden_layers"] - 1
    assert names.count("repro.mla.attention") == 2 * layers
    for span in ("route", "dispatch", "experts", "combine"):
        assert names.count(f"repro.moe.{span}") == 2 * units, span


def _trace(events):
    base = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
             "ts": 0.0, "dur": 1000.0}]
    return devtrace.Trace(base + [
        {"ph": "X", "cat": e[0], "name": e[1], "ts": e[2], "dur": e[3],
         "args": {"correlation": e[4]} if len(e) > 4 else {}}
        for e in events])


def _step_trace():
    """Two traced steps that launched work and one that launched none.
    Step 1's attention launches two overlapping kernels (10..30 and
    20..40: 30 us merged), its route one (40..45), its experts one
    (45..60) and its combine one (60..62); step 2's attention one
    (510..520)."""
    return _trace([
        ("user_annotation", "fwd_bwd", 0.0, 100.0),
        ("user_annotation", "repro.mla.attention", 1.0, 3.0),
        ("user_annotation", "repro.moe.route", 5.0, 1.0),
        ("user_annotation", "repro.moe.experts", 6.0, 1.0),
        ("user_annotation", "repro.moe.combine", 7.0, 1.0),
        ("user_annotation", "fwd_bwd", 500.0, 100.0),
        ("user_annotation", "repro.mla.attention", 501.0, 1.0),
        ("user_annotation", "fwd_bwd", 900.0, 10.0),
        ("cuda_runtime", "cudaLaunchKernel", 2.0, 0.2, 1),
        ("cuda_runtime", "cudaLaunchKernel", 3.0, 0.2, 2),
        ("cuda_runtime", "cudaLaunchKernel", 5.5, 0.2, 3),
        ("cuda_runtime", "cudaLaunchKernel", 6.5, 0.2, 4),
        ("cuda_runtime", "cudaLaunchKernel", 7.5, 0.2, 5),
        ("cuda_runtime", "cudaLaunchKernel", 501.5, 0.2, 6),
        ("cuda_runtime", "cudaLaunchKernel", 9.0, 0.2, 7),
        ("kernel", "scores", 10.0, 20.0, 1),
        ("kernel", "softmax", 20.0, 20.0, 2),
        ("kernel", "sort", 40.0, 5.0, 3),
        ("kernel", "grouped_mm", 45.0, 15.0, 4),
        ("kernel", "gather", 60.0, 2.0, 5),
        ("kernel", "scores", 510.0, 10.0, 6),
        ("kernel", "backward", 62.0, 30.0, 7)])


class Run:
    def __init__(self, tr, config=FULL, traffic_=None, facts=None):
        self.devtrace, self.config = tr, config
        self.traffic = traffic_ or load_json(
            ROOT / "cxlbench/traffic/train-4x4096-fused.json")
        self.facts = facts or {}


@pytest.mark.parametrize("name, busy_us", [
    ("mla_attention_ms", 30.0 + 10.0),
    ("moe_dispatch_ms", 5.0 + 2.0),
    ("moe_experts_ms", 15.0),
])
def test_span_readers_give_merged_device_time_a_step(name, busy_us):
    got = load_piece("metrics", name).read(Run(_step_trace()))
    assert got == pytest.approx(busy_us * 1e-3 / 2)


def test_the_attention_roofline_is_its_least_time_over_the_spans_time():
    run = Run(_step_trace())
    least = load_piece("metrics", "mla_attention_roofline").least_seconds(
        FULL, run.traffic)
    got = load_piece("metrics", "mla_attention_roofline").read(run)
    assert got == pytest.approx(100.0 * least / (40e-6 / 2))
    # compute-bound: forward and recompute of 27 layers' projections
    # (2 x 13,762,560 FLOPs a token) and causal products (2 x 16 x 320 a
    # pair) at 4 x 4,096 tokens
    flops = 2 * (2 * 27 * 13_762_560 * 16_384
                 + 27 * 2 * 16 * 320 * 4 * 4096 * 4097 / 2)
    assert least == pytest.approx(flops / 989e12)


@pytest.mark.parametrize("name", ["mla_attention_ms", "moe_dispatch_ms",
                                  "moe_experts_ms", "mla_attention_roofline"])
def test_span_readers_read_nothing_without_a_trace_or_their_spans(name):
    reader = load_piece("metrics", name)
    assert reader.read(Run(None)) is None
    bare = _trace([("kernel", "k", 0.0, 20.0),
                   ("user_annotation", "fwd_bwd", 0.0, 50.0)])
    assert reader.read(Run(bare)) is None


def test_the_held_load_reader_reads_the_counted_histogram():
    reader = load_piece("metrics", "held_load_max_over_mean")
    assert reader.read(Run(None, facts={"held_load": [2.0, 4.0, 6.0]})) \
        == pytest.approx(1.5)
    assert reader.read(Run(None)) is None
    assert reader.read(Run(None, facts={"held_load": [0.0, 0.0]})) is None


def test_step_flops_by_hand():
    """152.7 TFLOP a step at 4 x 4,096: the FLOP bound 0.154 s."""
    per_token = (27 * 13_762_560 + 3 * 2048 * 10_944
                 + 26 * (2048 * 64 + 2 * 3 * 2048 * 1408
                         + 6 * 8 / 64 * 3 * 2048 * 1408)
                 + 2048 * 102_400)
    assert MFU.matmul_params(FULL) == per_token
    attn = 27 * 2 * 16 * (128 + 64 + 128) * 4 * 4096 * 4097 / 2
    assert MFU.step_flops(FULL, 4, 4096) == 3 * (2 * per_token * 16_384
                                                  + attn)
    assert MFU.step_flops(FULL, 4, 4096) / 1e12 == pytest.approx(152.73,
                                                                 abs=0.01)


def _renormalised_gates(monkeypatch):
    real = moe._route

    def route(x2d, router, spec, C):
        import dataclasses
        return real(x2d, router, dataclasses.replace(spec, norm_topk=True), C)
    monkeypatch.setattr(moe, "_route", route)


def _frozen(monkeypatch):
    monkeypatch.setattr(adamw, "apply",
                        lambda cfg, params, grads, state: (params, state, {}))


def _expert_gradient_altered(monkeypatch):
    real = moe.loss_and_grad

    def loss_and_grad(cfg, params, batch, **kw):
        loss, grads = real(cfg, params, batch, **kw)
        grads["units.moe.experts.w_up"] = grads["units.moe.experts.w_up"] * 2.0
        return loss, grads
    monkeypatch.setattr(moe, "loss_and_grad", loss_and_grad)


@pytest.mark.parametrize("fault", [_renormalised_gates, _frozen,
                                   _expert_gradient_altered],
                         ids=["renormalised_gates", "state_unchanged",
                              "an_answer_altered"])
def test_a_broken_training_step_is_not_correct(run_tiny, monkeypatch, fault):
    fault(monkeypatch)
    result, checks = run_tiny(CELL)
    assert not result["correct"], checks


def test_the_window_counts_the_held_pairs_of_its_steps(checkout):
    """The timed window's histogram, read after it: every pair routed to
    a held expert in every MoE layer of every step, an expert at most one
    pair a token."""
    import time
    from cxlbench import harness
    from cxlbench.common import Spans
    _, cell, config, tr = harness.resolve(checkout, CELL)
    run = harness.Run(cell=cell, config=config, traffic=tr, seed=2**31 + 3,
                      seconds=0.2, device=CPU, spans=Spans(enabled=False),
                      t_start=time.perf_counter())
    driver = load_piece("drivers", tr["driver"], checkout)
    driver.setup(run)
    run.timed = driver.window(run, 0.2)
    driver.facts(run)
    load = run.facts["held_load"]
    tokens = tr["batch"] * tr["seq"]
    units = config["num_hidden_layers"] - config["first_k_dense_replace"]
    assert len(load) == config["n_routed_experts"]
    assert all(v == int(v) for v in load) and sum(load) > 0
    assert max(load) <= run.timed["ops"] * units * tokens
    assert load_piece("metrics", "held_load_max_over_mean").read(run) >= 1
