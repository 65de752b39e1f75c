"""The harness finds every piece by name, runs each cell's tiny copy on the
CPU (a cell of a new configuration, traffic and driver too, added as files
with its tiny cuts), refuses to measure without a card or without the
program, and reduces a profiler trace as the readers need."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from checkout import (ROOT, CutError, cut_path, make_checkout,
                      run_tiny as run_in)

torch = pytest.importorskip("torch")

from cxlbench import devtrace, harness  # noqa: E402
from cxlbench.common import (  # noqa: E402
    family_value, forbidden_loaded, load_json, load_piece)

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = [c["name"] for c in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(cell):
    bench, entry, config, traffic = harness.resolve(ROOT, cell)
    driver = load_piece("drivers", traffic["driver"])
    for fn in ("setup", "window", "end_to_end", "facts", "release", "check"):
        assert callable(getattr(driver, fn)), fn
    assert config["limits"], "a configuration states its check's limits"
    e2e = [m["name"] for m in bench["end_to_end"]
           if harness.applies(m, cell)]
    layer = [m["name"] for m in bench["per_layer"]
             if harness.applies(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for name in layer:
        assert callable(load_piece("metrics", name).read), name


def test_metric_entries_name_known_cells_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert harness.applies(e2e[m["moves"]], cell), (m["name"], cell)


def test_an_unknown_name_is_refused():
    with pytest.raises(harness.BenchError):
        harness.resolve(ROOT, "no-such-cell")
    with pytest.raises(harness.BenchError):
        load_piece("metrics", "no_such_metric")


@pytest.mark.parametrize("cell", CELLS)
def test_each_tiny_cell_runs_correct_on_the_cpu(run_tiny, cell):
    result, checks = run_tiny(cell)
    assert result["correct"], checks
    want = {m["name"] for m in BENCH["end_to_end"] if harness.applies(m, cell)}
    assert set(result["metrics"]) == want
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {n for n, _, _ in checks}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert result["device"]["platform"] == "cpu"


def _tree(tmp_path):
    """A copy of the repository's benchmark (``BENCHMARK.json`` and
    ``cxlbench``, its tests and tiny cuts with it) that a test adds files
    to, as a later change would."""
    tree = tmp_path / "tree"
    shutil.copytree(ROOT / "cxlbench", tree / "cxlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tree / "BENCHMARK.json")
    return tree


def _files(tree) -> dict:
    return {p.relative_to(tree): p.read_bytes()
            for p in tree.rglob("*") if p.is_file()}


def _edited(tree, before: dict) -> list:
    now = _files(tree)
    return sorted(str(k) for k in before if now.get(k) != before[k])


def _write(path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2))


def test_a_cell_added_as_files_runs_without_editing_any(tmp_path):
    tree = _tree(tmp_path)
    before = _files(tree)
    zipf = load_json(tree / "cxlbench/traffic/zipf-8192x80.json")
    _write(tree / "cxlbench/traffic/zipf0.9-8192x80.json",
           {**zipf, "zipf_alpha": 0.9})
    _write(tree / cut_path("traffic", "zipf0.9-8192x80"),
           load_json(tree / cut_path("traffic", "zipf-8192x80")))
    bench = load_json(tree / "BENCHMARK.json")
    bench["workloads"].append({"name": "dlrm-zipf09", "chips": 1,
                               "config": "dlrm-merci-hbm10",
                               "traffic": "zipf0.9-8192x80", "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dlrm-zipf" in m.get("workloads", []):
            m["workloads"].append("dlrm-zipf09")
    _write(tree / "BENCHMARK.json", bench)
    assert _edited(tree, before) == ["BENCHMARK.json"]
    root = make_checkout(tmp_path / "checkout", tree)
    result, _ = run_in(root, "dlrm-zipf09", seed=5, seconds=0.2)
    assert result["correct"]
    assert {"bags_per_s", "lookup_p95_ms", "setup_s"} == set(result["metrics"])


#: a training cell of a new configuration, traffic and driver
NEW = {"cell": "gqa-x-train-tiered50", "config": "gqa-decoder-x",
       "traffic": "train-8x2048-tiered50", "driver": "dense_train_step"}
NEW_DRIVER = '''"""Training steps of a dense decoder, as ``train_step`` runs them."""
from cxlbench.drivers.train_step import (  # noqa: F401
    KEYS, check, end_to_end, facts, release, setup, window)
'''


def _add_training_family(tree, cuts: bool) -> None:
    """``NEW``'s files, and its entries in ``BENCHMARK.json``: the cell
    reports ``train_tokens_per_s``, and a copy of each of the offload
    cell's per-layer metrics, named ``<name>.gqa``, is read in it."""
    sc2 = load_json(tree / "cxlbench/configs/starcoder2-3b.json")
    _write(tree / f"cxlbench/configs/{NEW['config']}.json",
           {**sc2, "name": NEW["config"], "num_hidden_layers": 24,
            "hidden_size": 2048, "num_attention_heads": 16,
            "num_key_value_heads": 4, "intermediate_size": 8192})
    offload = load_json(tree / "cxlbench/traffic/train-4x1024-tiered25.json")
    _write(tree / f"cxlbench/traffic/{NEW['traffic']}.json",
           {**offload, "driver": NEW["driver"], "batch": 8, "seq": 2048,
            "slow_fraction": 0.5})
    (tree / f"cxlbench/drivers/{NEW['driver']}.py").write_text(NEW_DRIVER)
    if cuts:
        _write(tree / cut_path("configs", NEW["config"]),
               {"num_hidden_layers": 3, "hidden_size": 64,
                "num_attention_heads": 4, "num_key_value_heads": 1,
                "head_dim": 16, "intermediate_size": 96, "vocab_size": 4096,
                "sliding_window": 12, "torch_dtype": "float32"})
        _write(tree / cut_path("traffic", NEW["traffic"]),
               {"batch": 2, "seq": 16, "trace_seconds": 1})
    bench = load_json(tree / "BENCHMARK.json")
    bench["configs"].append({
        "name": NEW["config"], "source": "a test", "reduced": [],
        "file": f"cxlbench/configs/{NEW['config']}.json", "why": "a test"})
    bench["workloads"].append({"name": NEW["cell"], "config": NEW["config"],
                               "traffic": NEW["traffic"], "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append(NEW["cell"])
    bench["per_layer"] += [
        {**m, "name": f"{m['name']}.gqa", "workloads": [NEW["cell"]]}
        for m in list(bench["per_layer"])
        if "sc2-3b-train-offload" in m.get("workloads", [])]
    _write(tree / "BENCHMARK.json", bench)


def test_a_training_cell_of_a_new_family_is_added_as_files(tmp_path):
    tree = _tree(tmp_path)
    before = _files(tree)
    _add_training_family(tree, cuts=True)
    assert _edited(tree, before) == ["BENCHMARK.json"]
    root = make_checkout(tmp_path / "checkout", tree)
    result, checks = run_in(root, NEW["cell"], seed=2**31 + 5)
    assert result["correct"], checks
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert result["attempted"] > 0 and result["failed"] == 0
    bench, _, config, traffic = harness.resolve(root, NEW["cell"])
    assert config["hidden_size"] == 64 and traffic["seq"] == 16
    layer = [m["name"] for m in bench["per_layer"]
             if harness.applies(m, NEW["cell"])]
    assert len(layer) >= 5
    for name in layer:
        assert callable(load_piece("metrics", name, root).read), name


def test_a_cell_without_its_tiny_cuts_never_runs(tmp_path):
    tree = _tree(tmp_path)
    _add_training_family(tree, cuts=False)
    root = make_checkout(tmp_path / "checkout", tree)
    with pytest.raises(CutError) as e:
        run_in(root, NEW["cell"])
    for kind, name in (("configs", NEW["config"]),
                       ("traffic", NEW["traffic"])):
        assert str(cut_path(kind, name)) in str(e.value)
    # no full-size copy is left for anything to run
    assert not (root / f"cxlbench/configs/{NEW['config']}.json").exists()
    assert not (root / f"cxlbench/traffic/{NEW['traffic']}.json").exists()
    result, checks = run_in(root, "sc2-3b-train-fused-8x1024")
    assert result["correct"], checks


def test_a_cut_that_sets_a_key_its_file_lacks_is_refused(tmp_path):
    tree = _tree(tmp_path)
    path = tree / cut_path("configs", "starcoder2-3b")
    _write(path, {**load_json(path), "n_routed_experts": 8})
    root = make_checkout(tmp_path / "checkout", tree)
    for cell in ("sc2-3b-train-offload", "sc2-3b-train-fused-8x1024"):
        with pytest.raises(CutError, match="n_routed_experts"):
            run_in(root, cell)
    result, checks = run_in(root, "dlrm-zipf")
    assert result["correct"], checks


def _cli(cwd, *args):
    return subprocess.run(
        [sys.executable, "cxlbench/run.py", "--workload", "dlrm-zipf",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0", *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here; the refusal is for a machine without")
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_the_command_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cxlbench", tmp_path / "cxlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules_are_compared_by_whole_top_level_name():
    found = forbidden_loaded({"repro_torch.core": 1, "jax.numpy": 1,
                              "repro": 1, "reprox": 1, "flax": 1,
                              "jaxlib.xla": 1, "torch": 1})
    assert found == ["flax", "jax.numpy", "jaxlib.xla", "repro"]


def _trace(events):
    """A trace of (category, name, start, duration[, correlation])."""
    base = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
             "ts": 0.0, "dur": 100.0}]
    return devtrace.Trace(base + [
        {"ph": "X", "cat": e[0], "name": e[1], "ts": e[2], "dur": e[3],
         "args": {"correlation": e[4]} if len(e) > 4 else {}}
        for e in events])


def test_a_trace_is_reduced_to_busy_time_spans_and_gaps():
    tr = _trace([("user_annotation", "lookup", 0.0, 40.0),
                 ("user_annotation", "lookup", 50.0, 40.0),
                 ("kernel", "bag_kernel", 5.0, 20.0),
                 ("kernel", "bag_kernel", 15.0, 20.0),
                 ("gpu_memcpy", "Memcpy HtoD", 60.0, 10.0),
                 ("kernel", "outside", 95.0, 10.0)])
    assert tr.window_s == pytest.approx(100e-6)
    # 5..35 and 60..70 and 95..100 inside the window
    assert tr.busy_s == pytest.approx(45e-6)
    assert [op[0] for op in tr.in_spans("lookup")] == [
        "bag_kernel", "bag_kernel", "Memcpy HtoD"]
    b = tr.breakdown()
    assert b["device_ops"][0] == ["bag_kernel", pytest.approx(40e-6)]
    gaps = b["idle_gaps"]
    assert gaps[0] == ["lookup", pytest.approx(25e-6)]  # 35..60
    assert sorted(g[1] for g in gaps) == pytest.approx(
        sorted([5e-6, 25e-6, 25e-6]))


def test_device_work_belongs_to_the_span_that_launched_it():
    # the host runs ahead: fwd_bwd launches k1 and k2, which run while
    # opt_step is open on the host; opt_step's k3 runs after both
    tr = _trace([("user_annotation", "fwd_bwd", 0.0, 10.0),
                 ("user_annotation", "opt_step", 10.0, 10.0),
                 ("cuda_runtime", "cudaLaunchKernel", 2.0, 1.0, 1),
                 ("cuda_runtime", "cudaLaunchKernel", 4.0, 1.0, 2),
                 ("cuda_driver", "cuLaunchKernel", 12.0, 1.0, 3),
                 ("kernel", "k1", 11.0, 20.0, 1),
                 ("kernel", "k2", 31.0, 20.0, 2),
                 ("kernel", "k3", 55.0, 5.0, 3)])
    assert [op[0] for op in tr.in_spans("fwd_bwd")] == ["k1", "k2"]
    assert [op[0] for op in tr.in_spans("opt_step")] == ["k3"]
    assert [len(ops) for ops in tr.by_span("fwd_bwd")] == [2]


def test_a_trace_without_device_work_is_refused():
    with pytest.raises(RuntimeError):
        _trace([("user_annotation", "lookup", 0.0, 40.0)])


def test_idle_share_reader_reads_the_trace():
    class R:
        devtrace = _trace([("kernel", "k", 0.0, 25.0)])
    assert load_piece("metrics", "idle_share.dlrm").read(R) == \
        pytest.approx(0.75)
    R.devtrace = None
    assert load_piece("metrics", "idle_share.train").read(R) is None


def test_a_dotted_name_falls_back_to_its_family():
    assert load_piece("metrics", "idle_share.train.fused").__file__.endswith(
        "idle_share.py")
    assert family_value({"a": 1, "a.b": 2}, "a.b.c") == 2
    assert family_value({"a": 1}, "a.x") == 1
    assert family_value({"a": 1}, "b.a") is None


def test_a_traffic_parameter_no_driver_implements_is_refused(tmp_path):
    root = make_checkout(tmp_path)
    path = root / "cxlbench/traffic/zipf-8192x80.json"
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                "in_flight": 4}))
    import time
    with pytest.raises(harness.BenchError, match="in_flight"):
        harness.run_cell("dlrm-zipf", 5, 0.2, False,
                         t_start=time.perf_counter(), root=root,
                         device="cpu")


def test_the_training_window_reads_each_loss_lag_steps_late(monkeypatch):
    """Loss k is read just after step k + lag is sent; once the time is up
    no step is sent, every loss is read, and every step sent counts."""
    drv = load_piece("drivers", "train_step")
    lag, sent, read = 3, [], []

    class Loss:
        def __init__(self, k):
            self.k = k

        def __float__(self):
            read.append((self.k, len(sent)))
            return 0.0

    def step(run):
        sent.append(Loss(len(sent)))
        return sent[-1]

    class R:
        device = torch.device("cpu")
        state = {"lag": lag}
    monkeypatch.setattr(drv, "step", step)
    w = drv.window(R, 0.05)
    n = len(sent)
    assert w["ops"] == n > lag
    assert read == [(k, min(k + 1 + lag, n)) for k in range(n)]


@pytest.mark.cuda
def test_the_tiny_cells_run_correct_on_the_card(run_tiny, card):
    for cell in CELLS:
        result, checks = run_tiny(cell, device="cuda", seconds=0.5)
        assert result["correct"], (cell, checks)
        assert result["device"]["platform"] == "gpu"
