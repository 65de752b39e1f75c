"""The bytes and FLOPs behind the rooflines and the steps' shares of the
peak, on hand-checked cases."""
from __future__ import annotations

import pytest

from cxlbench import peaks
from cxlbench.common import load_json, load_piece
from checkout import ROOT

ROOF = load_piece("metrics", "lookup_kernel_roofline")
MFU = load_piece("metrics", "train_mfu")


def test_a_batch_least_time_is_its_slower_tier():
    shape = {"bags": 2, "lookups": 3, "row_bytes": 256, "out_bytes": 256}
    io = 2 * 3 * 4 + 2 * 256
    # no pinned rows: HBM bytes bound it
    assert ROOF.least_seconds(6, 0, **shape) == pytest.approx(
        (6 * 256 + io) / peaks.HBM_BYTES)
    # one pinned row is slower than the whole HBM side
    assert ROOF.least_seconds(5, 1, **shape) == pytest.approx(
        256 / peaks.PCIE_BYTES_EACH_WAY)


TINY = {"num_hidden_layers": 2, "hidden_size": 4, "num_attention_heads": 2,
        "num_key_value_heads": 1, "head_dim": 2, "intermediate_size": 8,
        "vocab_size": 10, "use_bias": "qkv", "tie_word_embeddings": True,
        "sliding_window": 0}


def test_parameters_by_hand():
    # a layer: q 4x4, k and v 4x2 each, o 4x4, MLP 2 * 4x8: 112; head 40
    assert MFU.matmul_params(TINY) == 2 * 112 + 40
    # + layer norms 2 * 4 * 4, final norm 8, biases 2 * (4 + 2 + 2)
    assert MFU.all_params(TINY) == 264 + 32 + 8 + 16


def test_step_flops_by_hand():
    # forward: 2 * 264 a token, attention 4 * H * hd * (1 + 2 + 3) a
    # layer; the step three times that
    fwd = 2 * 264 * 3 + 2 * 4 * 2 * 2 * 6
    assert MFU.step_flops(TINY, 1, 3) == 3 * fwd
    windowed = dict(TINY, sliding_window=2)
    assert MFU.step_flops(windowed, 1, 3) == 3 * (
        2 * 264 * 3 + 2 * 4 * 2 * 2 * 5)


def test_starcoder2_counts_agree_with_the_port():
    import sys
    sys.path.insert(0, str(ROOT / "src"))
    drv = load_piece("drivers", "train_step")
    cfg = load_json(ROOT / "cxlbench/configs/starcoder2-3b.json")
    L, D = cfg["num_hidden_layers"], cfg["hidden_size"]
    norms = 4 * L * D + 2 * D  # the port's count leaves the norms out
    assert MFU.all_params(cfg) - norms == drv.arch_config(cfg).param_count()
    # 25% of 12 bytes a parameter each way over PCIe: ~142 ms
    assert MFU.paging_seconds(cfg, 0.25) == pytest.approx(0.142, rel=0.01)
