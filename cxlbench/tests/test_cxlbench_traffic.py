"""The one generator: the same seed gives the same inputs, another seed
others, and each distribution has the shape its traffic file states."""
from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")

from cxlbench import weights  # noqa: E402
from cxlbench.traffic import BagTraffic, token_batch  # noqa: E402

CPU = torch.device("cpu")
N_KEYS, RPK, LOOKUPS = 512, 64, 80


def bags(kind: str, seed: int, **kw) -> torch.Tensor:
    tr = {"distribution": kind, "zipf_alpha": 1.1, "bags": 256, **kw}
    return BagTraffic(tr, n_keys=N_KEYS, rows_per_key=RPK, lookups=LOOKUPS,
                      seed=seed, device=CPU).draw(20)


@pytest.mark.parametrize("kind", ["zipf", "uniform"])
def test_the_same_seed_gives_the_same_batches(kind):
    a, b = bags(kind, 2**31 + 11), bags(kind, 2**31 + 11)
    assert a.dtype == torch.int32 and a.shape == (20, 256, LOOKUPS)
    assert torch.equal(a, b)
    assert not torch.equal(a, bags(kind, 2**31 + 12))
    assert int(a.min()) >= 0 and int(a.max()) < N_KEYS * RPK


def _hot_share(rows: torch.Tensor, share: float = 0.1) -> float:
    counts = torch.bincount(rows.reshape(-1).long() // RPK,
                            minlength=N_KEYS).sort(descending=True).values
    return float(counts[:int(share * N_KEYS)].sum() / counts.sum())


def test_zipf_keys_are_skewed_and_uniform_rows_are_not():
    # Zipf(1.1) over 512 keys: the hottest 10% take sum_{r<=51} r^-1.1 /
    # sum_{r<=512} r^-1.1 of the lookups
    h = [r ** -1.1 for r in range(1, N_KEYS + 1)]
    want = sum(h[:51]) / sum(h)
    assert _hot_share(bags("zipf", 5)) == pytest.approx(want, abs=0.02)
    assert _hot_share(bags("uniform", 5)) < 0.13


def test_zipf_rows_are_uniform_within_their_key():
    offsets = bags("zipf", 9).reshape(-1).long() % RPK
    counts = torch.bincount(offsets, minlength=RPK).double()
    assert float(counts.std() / counts.mean()) < 0.05


def test_a_token_batch_is_its_step_and_seed_alone():
    a = token_batch(7, 3, batch=2, seq=16, vocab=4096, device=CPU)
    b = token_batch(7, 3, batch=2, seq=16, vocab=4096, device=CPU)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    other = token_batch(7, 4, batch=2, seq=16, vocab=4096, device=CPU)
    assert not torch.equal(a["tokens"], other["tokens"])
    assert int(a["tokens"].max()) < 4096


def test_weights_are_drawn_a_leaf_at_a_time_from_the_seed():
    cfg = {"num_hidden_layers": 2, "hidden_size": 64,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 16, "intermediate_size": 128, "vocab_size": 256,
           "torch_dtype": "bfloat16", "use_bias": "qkv",
           "tie_word_embeddings": True}
    leaves = weights.dense_leaves(cfg)
    whole = weights.dense_weights(cfg, 3, CPU)
    for i, leaf in enumerate(leaves):
        alone = weights.make_leaf(leaf, i, 3, CPU)
        assert torch.equal(alone, whole[leaf.name]), leaf.name
        assert alone.dtype == leaf.dtype and tuple(alone.shape) == leaf.shape
    wq = whole["layers.attn.wq"].float()
    assert float(wq.std()) == pytest.approx(1 / math.sqrt(64), rel=0.05)
    assert "lm_head" not in whole
    table = weights.dlrm_table({"rows": 128, "dim": 64}, 4, CPU)
    assert torch.equal(table, weights.dlrm_table({"rows": 128, "dim": 64},
                                                 4, CPU))
