"""A checkout of tiny cells for the CPU: the benchmark's own files, tiny
configurations beside them (the same limits), and the port under
``src``."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

TINY_DLRM = {"rows": 4096, "dim": 64, "dtype": "float32",
             "lookups_per_bag": 80, "page_rows": 64, "rows_per_key": 64,
             "hbm_page_share": 0.10, "placement": "blind",
             "ledger_decay": 0.5, "headroom_pages": 8,
             "retier_warmup_batches": 4}
TINY_DECODER = {"arch": "starcoder2-3b", "num_hidden_layers": 2,
                "hidden_size": 64, "num_attention_heads": 4,
                "num_key_value_heads": 2, "head_dim": 16,
                "intermediate_size": 128, "vocab_size": 4096,
                "hidden_act": "gelu_pytorch_tanh", "norm_type": "layer_norm",
                "norm_epsilon": 1e-05, "rope_theta": 999999.4420358813,
                "sliding_window": 12, "tie_word_embeddings": True,
                "use_bias": "qkv", "torch_dtype": "float32"}
TINY_TRAFFIC = {
    "zipf-8192x80": {"bags": 64, "pool_batches": 8, "check_batches": 4},
    "uniform-8192x80": {"bags": 64, "pool_batches": 8, "check_batches": 4},
    "train-4x1024-tiered25": {"batch": 2, "seq": 16, "trace_seconds": 1},
    "train-4x1024-fused": {"batch": 2, "seq": 16, "trace_seconds": 1},
}


def make_checkout(dest: Path) -> Path:
    """A checkout at ``dest`` whose cells are the benchmark's, cut tiny."""
    shutil.copytree(ROOT / "cxlbench", dest / "cxlbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        path = dest / entry["file"]
        cfg = json.loads(path.read_text())
        tiny = TINY_DLRM if "rows" in cfg else TINY_DECODER
        path.write_text(json.dumps({**cfg, **tiny}))
    for name, tiny in TINY_TRAFFIC.items():
        path = dest / "cxlbench" / "traffic" / f"{name}.json"
        path.write_text(json.dumps({**json.loads(path.read_text()), **tiny}))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def checkout(tmp_path_factory) -> Path:
    return make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def run_tiny(checkout):
    """``run_tiny(cell, seed, trace=False, root=checkout, device="cpu")``
    -> (result, checks) of one tiny run."""
    from cxlbench import harness

    def run(cell, seed=7, trace=False, root=None, device="cpu",
            overrides=None, seconds=0.3):
        return harness.run_cell(cell, seed, seconds, trace,
                                t_start=time.perf_counter(),
                                root=root or checkout, device=device,
                                overrides=overrides)
    return run


@pytest.fixture
def card():
    """The card, where there is one; the test skips without it."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
