"""The paper's figure scripts in both packages, on the CPU: the port's
``repro_torch.benchmarks`` against the reference's ``benchmarks``.

Every modeled row (``us_per_call`` 0, or a derived model time) must read
the same letter for letter, with one named exception: the reference's
``jit_traces=1`` (and ``traces=1``) rows read ``shard_bindings=1`` on the
port (one binding of the walk tensor's shards, what one trace
certifies).  Rows that carry a
wall-clock time are held through their JSON's non-timing fields instead.
The hot-path sections run without their speedup gates here (a timing
gate does not belong in a CPU test run); ``chip_smoke.py`` phase 9 runs
the gated ``run`` on the card."""
import ast
import contextlib
import dataclasses
import io
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import bench_hotness as r_hotness  # noqa: E402
from benchmarks import bench_hotpaths as r_hot  # noqa: E402
from benchmarks import bench_serving as r_serving  # noqa: E402
from benchmarks import fig2_latency as r_fig2  # noqa: E402
from benchmarks import fig3_seq_bw as r_fig3  # noqa: E402
from benchmarks import fig4_dsa as r_fig4  # noqa: E402
from benchmarks import fig5_random as r_fig5  # noqa: E402
from benchmarks import fig6_redis as r_fig6  # noqa: E402
from benchmarks import fig8_dlrm as r_fig8  # noqa: E402
from benchmarks import fig10_dsb as r_fig10  # noqa: E402
from benchmarks import fig11_caption as r_fig11  # noqa: E402
from benchmarks import fig_elastic as r_elastic  # noqa: E402
from repro.core.interleave import resolve_backend as r_backend  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro_torch.benchmarks import bench_hotness as t_hotness  # noqa: E402
from repro_torch.benchmarks import bench_hotpaths as t_hot  # noqa: E402
from repro_torch.benchmarks import bench_serving as t_serving  # noqa: E402
from repro_torch.benchmarks import fig2_latency as t_fig2  # noqa: E402
from repro_torch.benchmarks import fig3_seq_bw as t_fig3  # noqa: E402
from repro_torch.benchmarks import fig4_dsa as t_fig4  # noqa: E402
from repro_torch.benchmarks import fig5_random as t_fig5  # noqa: E402
from repro_torch.benchmarks import fig6_redis as t_fig6  # noqa: E402
from repro_torch.benchmarks import fig8_dlrm as t_fig8  # noqa: E402
from repro_torch.benchmarks import fig10_dsb as t_fig10  # noqa: E402
from repro_torch.benchmarks import fig11_caption as t_fig11  # noqa: E402
from repro_torch.benchmarks import fig_elastic as t_elastic  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import memo as t_memo  # noqa: E402
from repro_torch.examples import dlrm_embedding as t_dlrm_example  # noqa: E402
from repro_torch.examples import quickstart as t_quickstart  # noqa: E402
from repro_torch.examples import serve_tiered_kv as t_serve_kv  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: the serving JSON's wall-clock fields (the migration hidden/exposed
#: split is modeled, and compared)
SERVING_TIMING = {"wall_s", "goodput_tok_s", "ttft_p50_ms", "ttft_p99_ms",
                  "migration_stall_s", "sharing_goodput_speedup",
                  "overlap_stall_ratio"}


def _hot_timing(key: str) -> bool:
    return key.endswith("_s") or "speedup" in key


def _drop(tree, timing):
    """``tree`` without the keys ``timing`` names, recursively."""
    if isinstance(tree, dict):
        return {k: _drop(v, timing) for k, v in tree.items()
                if not timing(k)}
    return tree


@pytest.fixture(scope="module")
def fig8_rows():
    payload = {}
    return r_fig8.run(), t_fig8.run(device="cpu", payload=payload), payload


def test_fig8_modeled_rows_match_reference(fig8_rows):
    ref, port, payload = fig8_rows
    want = [r for r in ref if "/measured/" not in r]
    assert [r for r in port if "/measured/" not in r] == want
    assert any("/semantic/" in r for r in port)
    sem = payload["semantic"]
    assert sem["speedup"] > 1 and sem["retier"]["moved_pages"] > 0


def test_fig8_measured_row_is_one_routed_reduction(fig8_rows):
    _, port, payload = fig8_rows
    (row,) = [r for r in port if "/measured/" in r]
    name, us, derived = row.split(",")
    assert name == "fig8/measured/kernel_bag64x80" and float(us) > 0
    assert derived.startswith("rows_per_s=") and derived.endswith(
        ";launches=0")  # the plain version on the CPU launches nothing
    m = payload["measured"]
    assert m["backend"] == "modeled" and m["max_abs_err"] <= m["atol"]


def test_fig8_main_writes_its_json(tmp_path, capsys):
    out = tmp_path / "dlrm.json"
    t_fig8.main(["--device", "cpu", "--out", str(out)])
    assert f"fig8/json,0,wrote={out}" in capsys.readouterr().out
    import json
    assert json.loads(out.read_text())["measured"]["launches"] == 0


def test_fig10_rows_match_reference():
    payload = {}
    assert t_fig10.run(device="cpu", payload=payload) == r_fig10.run()
    act = payload["actuation"]
    assert act["stream_copy_launches"] == 0 and act["launch_bound"] > 0


def test_fig11_rows_match_reference():
    payload = {}
    port = t_fig11.run(device="cpu", payload=payload)
    ref = r_fig11.run()
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        if "/retrace_free," in r:
            assert r.endswith(";jit_traces=1")
            assert p == r.replace("jit_traces=1", "shard_bindings=1")
        else:
            assert p == r
    audit = payload["audit"]
    assert audit["pages"] == 64 and audit["descs2"] < audit["delta2"]
    assert audit["stream_copy_launches"] == [0, 0]


def test_fig11_control_plane_matches_reference():
    t_rows, t_bench = t_fig11.run_control(smoke=True)
    r_rows, r_bench = r_fig11.run_control(smoke=True)
    assert t_rows == r_rows
    assert t_bench == r_bench


def _reference_hotpaths(smoke: bool = True) -> dict:
    """The reference's ``bench_hotpaths.run`` sections, without its gates."""
    n_pages = 512 if smoke else r_hot.N_PAGES
    repeats = 2 if smoke else r_hot.REPEATS
    return {
        "config": {"n_pages": n_pages, "page_rows": r_hot.PAGE_ROWS,
                   "feature": r_hot.FEATURE, "smoke": smoke,
                   "backend": r_backend("auto")},
        "repartition": r_hot.bench_repartition(n_pages, repeats),
        "descriptors": r_hot.bench_descriptors(n_pages),
        "gather_scatter": r_hot.bench_gather_scatter(n_pages, repeats),
        "actuation": r_hot.bench_actuation(n_pages, repeats),
        "trace_stability": r_hot.bench_trace_stability(n_pages),
    }


def test_hotpaths_sections_match_reference():
    port = t_hot.measure(smoke=True, device="cpu")
    ref = _reference_hotpaths()
    assert port["config"].pop("backend") == "modeled"
    ref["config"].pop("backend")  # the reference's memory-kind resolution
    traces = ref["trace_stability"].pop("jit_traces")
    bindings = port["trace_stability"].pop("shard_bindings")
    assert traces == bindings == 1
    assert _drop(port, _hot_timing) == _drop(ref, _hot_timing)
    rows = t_hot.csv_rows({**port, "trace_stability": {
        **port["trace_stability"], "shard_bindings": bindings}})
    d = ref["descriptors"]
    assert rows[1] == (f"hotpaths/descriptors,0,delta={d['delta_pages']}"
                       f";descs={d['descriptors']};bytes_exact=1")
    assert rows[5] == "hotpaths/traces,0,epochs=12;shard_bindings=1"
    assert port["actuation"]["donated_full_shard_copies"] == 0


def test_hotpaths_gates_are_the_reference_gates():
    out = {"config": {"smoke": True},
           "repartition": {"speedup": 3.0},
           "gather_scatter": {"gather_speedup": 1.0,
                              "gather_multidev_speedup": 1.0},
           "actuation": {"speedup": 0.5}}
    t_hot.check(out)  # smoke: actuation timing is informational
    assert out["actuation"]["gated"] is False
    for section, key in (("repartition", "speedup"),
                         ("gather_scatter", "gather_speedup"),
                         ("gather_scatter", "gather_multidev_speedup")):
        bad = {k: dict(v) for k, v in out.items()}
        bad[section][key] = bad[section][key] * 0.99
        with pytest.raises(AssertionError):
            t_hot.check(bad)
    full = {k: dict(v) for k, v in out.items()}
    full["config"]["smoke"] = False
    with pytest.raises(AssertionError):
        t_hot.check(full)  # full size gates donated >= 2x
    full["actuation"]["speedup"] = 2.0
    t_hot.check(full)


def _scripted_stopwatch(monkeypatch, seconds):
    """``bench_hotpaths``' clock replaced by one that reads ``seconds`` in
    order, and its collector pause by one that counts its uses."""
    times = iter(seconds)
    paused = []

    def stopwatch(device):
        return lambda: next(times)

    @contextlib.contextmanager
    def gc_paused():
        paused.append(1)
        yield
    monkeypatch.setattr(t_hot, "stopwatch", stopwatch)
    monkeypatch.setattr(t_hot, "gc_paused", gc_paused)
    return times, paused


def test_hotpaths_repartition_timing_protocol(monkeypatch):
    """Intended divergence at smoke size: each repartition path gets an
    untimed pass, then ``TIMED_PASSES`` timed passes in turns with the
    collector paused, the fastest counting.  At full size (the
    reference's acceptance bar) the reference's timing: one pass of each
    path, legacy first, collector on."""
    assert t_hot.TIMED_PASSES == 5
    cpu = torch.device("cpu")
    # (legacy, new) per pass; the untimed first pass is the fastest of all
    script = [1e-6, 1e-6, 5.0, 1.0, 4.0, 2.0, 6.0, 0.5, 7.0, 3.0, 8.0, 4.0]
    times, paused = _scripted_stopwatch(monkeypatch, script)
    rep = t_hot.bench_repartition(64, 1, cpu)
    assert (rep["legacy_s"], rep["new_s"], rep["speedup"]) == (4.0, 0.5, 8.0)
    assert next(times, None) is None and len(paused) == 12
    times, paused = _scripted_stopwatch(monkeypatch, [3.0, 1.0])
    rep = t_hot.bench_repartition(64, 1, cpu, one_pass=True)
    assert (rep["legacy_s"], rep["new_s"], rep["speedup"]) == (3.0, 1.0, 3.0)
    assert next(times, None) is None and not paused
    flags = []
    monkeypatch.setattr(t_hot, "bench_repartition",
                        lambda n, r, d, one_pass=False: flags.append(
                            (n, one_pass)) or {})
    for name in ("bench_descriptors", "bench_gather_scatter",
                 "bench_actuation", "bench_trace_stability"):
        monkeypatch.setattr(t_hot, name, lambda *a, **k: {})
    t_hot.measure(smoke=True, device="cpu")
    t_hot.measure(smoke=False, device="cpu")
    assert flags == [(512, False), (t_hot.N_PAGES, True)]


def _recording(module):
    """Wrap ``module._run_mode`` to keep each mode's generated tokens."""
    tokens = {}
    orig = module._run_mode

    def rec(mode, *args, **kwargs):
        out, toks = orig(mode, *args, **kwargs)
        tokens[mode] = toks
        return out, toks
    return tokens, orig, rec


@pytest.fixture(scope="module")
def served():
    out = {}
    for side, module in (("ref", r_serving), ("port", t_serving)):
        tokens, orig, rec = _recording(module)
        module._run_mode = rec
        try:
            if side == "ref":
                rows, payload = module.run(smoke=True)
            else:
                arch = r_registry.get(module.ARCH).tiny()
                tree = arch.module.init(arch.cfg, jax.random.PRNGKey(0))
                cfg = t_registry.get(module.ARCH).tiny().cfg
                params = params_from_jax(
                    cfg, jax.tree_util.tree_map(np.asarray, tree),
                    device="cpu")
                rows, payload = module.run(smoke=True, device="cpu",
                                           params=params)
        finally:
            module._run_mode = orig
        out[side] = (rows, payload, tokens)
    return out


def test_serving_tokens_match_reference_per_mode(served):
    _, _, ref = served["ref"]
    _, _, port = served["port"]
    assert list(port) == list(ref) == list(t_serving.MODES)
    for mode in port:
        assert port[mode] == ref[mode], mode
        assert len(port[mode]) == 9 and all(len(t) == 6 for t in port[mode])


def test_serving_json_matches_reference(served):
    _, r_pay, _ = served["ref"]
    t_rows, t_pay, _ = served["port"]
    timing = SERVING_TIMING.__contains__
    ref, port = _drop(r_pay, timing), _drop(t_pay, timing)
    # intended divergence: the port counts each change of the decode
    # step's pool bindings, so a churn mode's rebuild retiles count where
    # the reference's shapes did not retrace (ROADMAP, intended
    # divergences, engine.py::decode_traces)
    for mode in ("sync", "overlap"):
        r_traces = ref["modes"][mode].pop("decode_traces")
        assert port["modes"][mode].pop("decode_traces") >= r_traces
    assert port == ref
    assert t_pay["modes"]["sharing"]["prefill_tokens_avoided"] > 0
    cow =t_pay["modes"]["sharing"]["prefix"]["cow_copies"]
    assert t_rows[0].endswith(
        f";prefill_avoided={t_pay['prefill_token_reduction']:.0%};cow={cow}")


# -- Figs. 2-6 and the examples -------------------------------------------------
MEMO_FIGURES = {"fig2": (r_fig2, t_fig2), "fig3": (r_fig3, t_fig3),
                "fig4": (r_fig4, t_fig4), "fig5": (r_fig5, t_fig5)}


def _modeled_and_measured(rows):
    """(rows without a measurement, (name, derived key) of each measured
    row): measured rows carry this machine's times."""
    measured = [r.split(",") for r in rows if "/measured/" in r]
    return ([r for r in rows if "/measured/" not in r],
            [(m[0], m[2].split("=")[0]) for m in measured])


@pytest.mark.parametrize("fig", sorted(MEMO_FIGURES))
def test_memo_figures_match_reference(fig):
    """Every modeled and claim row letter for letter; the measured rows
    under the same names, each with a time."""
    ref_mod, port_mod = MEMO_FIGURES[fig]
    ref, port = ref_mod.run(), port_mod.run(device="cpu")
    assert _modeled_and_measured(port) == _modeled_and_measured(ref)
    assert all(float(r.split(",")[1]) > 0 for r in port if "/measured/" in r)
    assert any("/measured/" in r for r in port)


def test_fig2_measures_the_cards_hbm(monkeypatch):
    """Intended divergence: on the card fig2's measured chase runs over a
    single-cycle 256 MiB table in HBM (the default memory, recorded as
    ``local``), past the 50 MB L2; on the CPU it keeps the reference's
    table and steps."""
    calls = []

    def chase(**kwargs):
        calls.append(kwargs)
        return t_memo.Record("ptr-chase", "local", "load", 1, 4, 1e-3, 4)
    monkeypatch.setattr(t_fig2.memo, "measure_pointer_chase", chase)
    t_fig2.run(device="cpu")
    assert calls == [dict(n_elems=1 << 20, steps=1 << 14,
                          device=torch.device("cpu"))]
    card = t_fig2.chase_args(torch.device("cuda", 0))
    assert card == dict(n_elems=t_fig2.CARD_CHASE_ELEMS, steps=1 << 14,
                        cycle=True, device=torch.device("cuda", 0))
    assert "memory" not in card and t_fig2.CARD_CHASE_ELEMS * 4 >= 256 << 20


def test_fig6_rows_match_reference():
    """Every row, the engine's modeled seconds included, with the
    reference's internvl2-2b ``.tiny()`` weights carried over."""
    arch = r_registry.get(t_fig6.ARCH).tiny()
    tree = arch.module.init(arch.cfg, jax.random.PRNGKey(0))
    params = params_from_jax(t_registry.get(t_fig6.ARCH).tiny().cfg,
                             jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")
    assert t_fig6.run(device="cpu", params=params) == r_fig6.run()


def _printed(fn) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue().splitlines()


def test_quickstart_prints_the_references_lines():
    """The modeled tier table and placement plan letter for letter, the
    chase record but for its time, the embedding-bag against the dense
    sum within the reference's bound."""
    ref = _printed(lambda: runpy.run_path(str(ROOT / "examples/quickstart.py"),
                                          run_name="__main__"))
    port = _printed(lambda: t_quickstart.main(["--device", "cpu"]))
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        if r.startswith(" measured ptr-chase:"):
            row = ast.literal_eval(p.split(":", 1)[1])  # Record.row()
            want = ast.literal_eval(r.split(":", 1)[1])
            assert row["seconds"] > 0
            for key in ("seconds", "GBps"):
                row.pop(key), want.pop(key)
            assert row == want
        elif r.startswith("tiered embedding-bag max err"):
            assert float(p.rsplit(" ", 1)[1]) <= 1e-5
        else:
            assert p == r


def _without_wall_times(line: str) -> str:
    return " ".join(w for w in line.split()
                    if not w.startswith(("wall=", "p50=", "p99=")))


def test_serve_example_prints_the_references_modeled_lines():
    """Four serving runs on internvl2-2b ``.tiny()`` over the tpu-v5e
    topology: completions, modeled p50, slow fraction, prefix and
    admission lines letter for letter; wall-clock times dropped."""
    ref = _printed(lambda: runpy.run_path(
        str(ROOT / "examples/serve_tiered_kv.py"), run_name="__main__"))
    port = _printed(lambda: t_serve_kv.main(["--device", "cpu"]))
    assert [_without_wall_times(x) for x in port] == [
        _without_wall_times(x) for x in ref]
    assert sum("modeled_p50=" in x for x in port) == 4


def test_run_harness_on_the_cpu(capsys):
    with pytest.raises(SystemExit) as done:
        t_run.main(["--device", "cpu"])
    assert done.value.code == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    claims = [line for line in out if "/claims," in line]
    assert [c.split(",")[0] for c in claims] == [
        f"{fig}/claims" for fig in ("fig2", "fig3", "fig4", "fig5", "fig6",
                                    "fig8", "fig10", "fig11", "hotness",
                                    "elastic")]
    assert all(",0,ALL-VALIDATED (" in c for c in claims)


def test_run_harness_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_run.main(["--only", "fig8"])


# -- the elastic timeline ---------------------------------------------------------
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_fig_elastic_rows_match_reference(smoke):
    """Segment A's controller timeline and Segment B's kill -> drain ->
    recover on internvl2-2b ``.tiny()`` (the reference's weights carried
    over): every row, the modeled ``step_us`` ones included."""
    arch = r_registry.get(t_elastic.ARCH).tiny()
    tree = arch.module.init(arch.cfg, jax.random.PRNGKey(0))
    params = params_from_jax(t_registry.get(t_elastic.ARCH).tiny().cfg,
                             jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")
    rows = t_elastic.run(smoke=smoke, device="cpu", params=params)
    assert rows == r_elastic.run(smoke=smoke)
    assert len(rows) == (3 if smoke else 7)


def test_run_harness_validates_elastic(capsys):
    with pytest.raises(SystemExit) as done:
        t_run.main(["--only", "elastic", "--device", "cpu"])
    assert done.value.code == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("fig_elastic/") for line in out) == 7
    assert out[-1].startswith("elastic/claims,0,ALL-VALIDATED (")


def test_fig_elastic_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_elastic.run(smoke=True)


# -- semantic tiering ----------------------------------------------------------------
def test_hotness_rows_match_reference():
    """Every section of ``bench_hotness --smoke`` in both packages, the moe
    section over the reference's parameters carried across: the rows
    letter for letter (the flip row's ``traces=1`` reads
    ``shard_bindings=1``; the dlrm row's re-tier time is the port's), and
    the JSON's non-timing fields equal."""
    from repro.models import moe as r_moe
    ref_rows, ref = r_hotness.run(smoke=True)
    cfg = t_hotness.moe_config(t_hotness.SMOKE)
    r_cfg = r_registry.get("deepseek-moe-16b").tiny().cfg
    r_cfg = dataclasses.replace(r_cfg, moe=dataclasses.replace(
        r_cfg.moe, n_experts=cfg.moe.n_experts, top_k=2))
    tree = jax.tree_util.tree_map(np.asarray,
                                  r_moe.init(r_cfg, jax.random.PRNGKey(0)))
    rows, port = t_hotness.run(
        smoke=True, device="cpu",
        moe_params=params_from_jax(cfg, tree, device="cpu"))

    def same_row(row: str) -> str:
        name, us, derived = row.split(",", 2)
        if name == "hotness/dlrm/bitexact":
            us = "t"
        return ",".join((name, us, derived.replace("traces=1",
                                                   "shard_bindings=1")))
    assert [same_row(r) for r in rows] == [same_row(r) for r in ref_rows]
    assert float(rows[1].split(",")[1]) > 0

    def plain(tree):
        return _drop(tree, lambda k: k in ("retier_s", "traces",
                                           "shard_bindings"))
    assert plain(port) == plain(ref)
    assert port["flip"]["shard_bindings"] == ref["flip"]["traces"] == 1


def test_hotness_main_writes_its_json(tmp_path, capsys):
    out = tmp_path / "hot.json"
    t_hotness.main(["--smoke", "--device", "cpu", "--out", str(out)])
    printed = capsys.readouterr().out
    assert f"hotness/json,0,wrote={out}" in printed
    assert "hotness/caption/walk" in printed and out.exists()


def test_dlrm_example_prints_the_references_lines(monkeypatch):
    """The placement reports, modeled rates, moves and the zero drift of
    the bag sums, letter for letter."""
    monkeypatch.setattr("sys.argv", ["dlrm_embedding.py"])
    ref = _printed(lambda: runpy.run_path(
        str(ROOT / "examples/dlrm_embedding.py"), run_name="__main__"))
    got = {}
    port = _printed(lambda: got.update(
        t_dlrm_example.main(["--device", "cpu"])))
    assert port == ref
    assert got["drift"] == 0.0 and got["hot_inf_s"] > got["blind_inf_s"]
