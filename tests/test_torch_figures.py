"""The paper's figure scripts in both packages, on the CPU: the port's
``repro_torch.benchmarks`` against the reference's ``benchmarks``.

Every modeled row (``us_per_call`` 0, or a derived model time) must read
the same letter for letter, with two named exceptions: the reference's
``jit_traces=1`` rows read ``shard_bindings=1`` on the port (one binding
of the walk tensor's shards, what one trace certifies), and fig8's
semantic rows wait for the port's hotness layer.  Rows that carry a
wall-clock time are held through their JSON's non-timing fields instead.
The hot-path sections run without their speedup gates here (a timing
gate does not belong in a CPU test run); ``chip_smoke.py`` phase 9 runs
the gated ``run`` on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import bench_hotpaths as r_hot  # noqa: E402
from benchmarks import bench_serving as r_serving  # noqa: E402
from benchmarks import fig8_dlrm as r_fig8  # noqa: E402
from benchmarks import fig10_dsb as r_fig10  # noqa: E402
from benchmarks import fig11_caption as r_fig11  # noqa: E402
from repro.core.interleave import resolve_backend as r_backend  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro_torch.benchmarks import bench_hotpaths as t_hot  # noqa: E402
from repro_torch.benchmarks import bench_serving as t_serving  # noqa: E402
from repro_torch.benchmarks import fig8_dlrm as t_fig8  # noqa: E402
from repro_torch.benchmarks import fig10_dsb as t_fig10  # noqa: E402
from repro_torch.benchmarks import fig11_caption as t_fig11  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402

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
    ref, port, _ = fig8_rows
    want = [r for r in ref if "/measured/" not in r and "/semantic/" not in r]
    assert [r for r in port if "/measured/" not in r] == want
    assert any("/semantic/" in r for r in ref)  # omitted by the port


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


def test_run_harness_on_the_cpu(capsys):
    with pytest.raises(SystemExit) as done:
        t_run.main(["--device", "cpu"])
    assert done.value.code == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    claims = [line for line in out if "/claims," in line]
    assert [c.split(",")[0] for c in claims] == [
        "fig8/claims", "fig10/claims", "fig11/claims"]
    assert all(",0,ALL-VALIDATED (" in c for c in claims)


def test_run_harness_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_run.main(["--only", "fig8"])
