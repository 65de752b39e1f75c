"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (the CPU runs the tiny cells) and
the rest of a run is driven as the command drives it.  The controls (one
precision step down) come out not correct as well."""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

import repro_torch.models.transformer as transformer  # noqa: E402
from repro_torch.core.interleave import InterleavedTensor  # noqa: E402
from repro_torch.optim import adamw, offload  # noqa: E402

DLRM = ["dlrm-zipf", "dlrm-uniform"]
TRAIN = ["sc2-3b-train-offload", "sc2-3b-train-fused-8x1024"]


def _broken_bags(monkeypatch, spoil):
    real = InterleavedTensor.bag_reduce

    def bag_reduce(self, indices, weights=None, reduce_fn=None):
        return spoil(real(self, indices, weights, reduce_fn=reduce_fn))
    monkeypatch.setattr(InterleavedTensor, "bag_reduce", bag_reduce)


def _half_bags(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0
    return out


def _one_sum_altered(out):
    out = out.clone()
    out[0, 0] += 1.0
    return out


@pytest.mark.parametrize("cell", DLRM)
@pytest.mark.parametrize("spoil", [_half_bags, _one_sum_altered],
                         ids=["half_the_batch_left_out", "an_answer_altered"])
def test_a_broken_lookup_is_not_correct(run_tiny, monkeypatch, cell, spoil):
    _broken_bags(monkeypatch, spoil)
    result, checks = run_tiny(cell)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", DLRM)
def test_the_bf16_table_control_is_not_correct(run_tiny, cell):
    result, checks = run_tiny(cell, overrides={"dtype": "bfloat16"})
    assert not result["correct"], checks


def _frozen(monkeypatch):
    monkeypatch.setattr(adamw, "apply",
                        lambda cfg, params, grads, state: (params, state, {}))
    monkeypatch.setattr(offload.TieredAdamW, "step",
                        lambda self, params, grads, state: (params, state, {}))


def _half_batch(monkeypatch):
    real = transformer.loss_and_grad

    def loss_and_grad(cfg, params, batch, **kw):
        half = batch["tokens"].shape[0] // 2
        return real(cfg, params, {k: v[:half] for k, v in batch.items()},
                    **kw)
    monkeypatch.setattr(transformer, "loss_and_grad", loss_and_grad)


def _gradient_altered(monkeypatch):
    real = transformer.loss_and_grad

    def loss_and_grad(cfg, params, batch, **kw):
        loss, grads = real(cfg, params, batch, **kw)
        grads["layers.mlp.w_up"] = grads["layers.mlp.w_up"] * 1.5
        return loss, grads
    monkeypatch.setattr(transformer, "loss_and_grad", loss_and_grad)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [_frozen, _half_batch, _gradient_altered],
                         ids=["state_unchanged", "half_the_batch_left_out",
                              "an_answer_altered"])
def test_a_broken_training_step_is_not_correct(run_tiny, monkeypatch, cell,
                                               fault):
    fault(monkeypatch)
    result, checks = run_tiny(cell)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", DLRM + TRAIN)
def test_a_sound_run_is_correct(run_tiny, cell):
    result, checks = run_tiny(cell, seed=2**31 + 99)
    assert result["correct"], checks
