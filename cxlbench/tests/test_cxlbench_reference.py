"""The plain references against hand-computed answers, and the training
reference against the port on the CPU."""
from __future__ import annotations

import math

import pytest

torch = pytest.importorskip("torch")

from checkout import ROOT, load_cut  # noqa: E402
from cxlbench.reference import dense_decoder as ref  # noqa: E402
from cxlbench.reference import dlrm  # noqa: E402

CPU = torch.device("cpu")
#: the CPU tests' cut of starcoder2-3b, whole enough to run alone
TINY_DECODER = load_cut(ROOT, "configs", "starcoder2-3b")
TRAFFIC = {"batch": 2, "seq": 16, "lr": 3e-4, "total_steps": 10,
           "checked_steps": 3}


def test_bag_sums_by_hand():
    table = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 6.0], [0.5, -1.0]])
    idx = torch.tensor([[0, 1, 1], [3, 2, 0]], dtype=torch.int32)
    want = torch.tensor([[7.0, 10.0], [6.5, 7.0]], dtype=torch.float64)
    assert torch.equal(dlrm.bag_sums(table, idx), want)


def test_relative_gap_is_the_largest_gap_over_the_rms():
    want = [torch.tensor([[3.0, 4.0]], dtype=torch.float64)]
    got = [torch.tensor([[3.0, 4.5]])]
    assert dlrm.relative_gap(got, want) == pytest.approx(
        0.5 / math.sqrt(12.5))


def test_lr_factor_warms_up_one_step_then_decays_by_a_cosine():
    assert ref.lr_factor(1, 10) == pytest.approx(1.0)
    assert ref.lr_factor(2, 10) == pytest.approx(
        0.1 + 0.45 * (1 + math.cos(math.pi / 9)))
    assert ref.lr_factor(10, 10) == pytest.approx(0.1)
    assert ref.lr_factor(5, 1000) == pytest.approx(0.05)


def test_one_adamw_step_moves_each_leaf_as_the_equations_say():
    """After one step Adam's update is g / (|g| + eps) elementwise, so each
    leaf's change is lr * (that + wd * p0)."""
    cfg = dict(TINY_DECODER)
    one = dict(TRAFFIC, checked_steps=1)
    out = ref.train_readings(cfg, one, 3, CPU, keep_grads=True)
    from cxlbench import weights
    for i, leaf in enumerate(weights.dense_leaves(cfg)):
        g = out["first_grads"][leaf.name].double()
        p0 = weights.make_leaf(leaf, i, 3, CPU).double()
        upd = g / (g.abs() + ref.EPS) + ref.WEIGHT_DECAY * p0
        want = 3e-4 * float(torch.linalg.vector_norm(upd))
        assert out["change_norms"][leaf.name] == pytest.approx(
            want, rel=1e-4, abs=1e-9), leaf.name


def test_the_reference_follows_the_port_on_the_cpu():
    """The port's loss and gradients of the same weights and tokens, in
    float32 (a test of the reference as much as of the port)."""
    import sys
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models import transformer
    from cxlbench import traffic, weights
    from cxlbench.common import load_piece
    drv = load_piece("drivers", "train_step")
    cfg = dict(TINY_DECODER)
    tree = drv._nest(weights.dense_weights(cfg, 5, CPU))
    params = transformer.DenseParams(tree["embed"], tree["layers"],
                                     tree["final_norm"], None)
    b = traffic.token_batch(5, 0, batch=2, seq=16, vocab=4096, device=CPU)
    loss, grads = transformer.loss_and_grad(drv.arch_config(cfg), params, b,
                                            remat=True)
    w = {k: v.float().requires_grad_(True)
         for k, v in weights.dense_weights(cfg, 5, CPU).items()}
    want = ref.Decoder(cfg, w).loss(b["tokens"], b["labels"])
    want_g = dict(zip(w, torch.autograd.grad(want, list(w.values()))))
    assert float(loss) == pytest.approx(float(want.detach()), rel=1e-5)
    for k, g in grads.items():
        torch.testing.assert_close(g, want_g[k], rtol=1e-3, atol=1e-6)


def test_the_fp8_control_and_the_faults_fail_the_limits():
    from cxlbench.common import load_json
    limits = load_json(ROOT / "cxlbench/configs/starcoder2-3b.json")["limits"]
    cfg = dict(TINY_DECODER)
    for kw in ({"precision": "fp8"}, {"fault": "half_batch"},
               {"fault": "frozen"}):
        got = ref.train_readings(cfg, TRAFFIC, 5, CPU, keep_grads=True, **kw)
        want = ref.train_readings(cfg, TRAFFIC, 5, CPU,
                                  against=got.pop("first_grads"))
        gaps = ref.compare(got, want)
        assert any(v > limits[k] for k, v in gaps.items()), (kw, gaps)
    sound = ref.train_readings(cfg, TRAFFIC, 5, CPU, keep_grads=True)
    want = ref.train_readings(cfg, TRAFFIC, 5, CPU,
                              against=sound.pop("first_grads"))
    assert all(v == 0 for v in ref.compare(sound, want).values())


def test_fp8_products_round_both_ways():
    a = torch.randn(3, 5, 8, requires_grad=True)
    b = torch.randn(8, 4, requires_grad=True)
    ref.Fp8MatMul.apply(a, b).sum().backward()
    ga, gb = a.grad.clone(), b.grad.clone()
    a.grad = b.grad = None
    (a @ b).sum().backward()
    for got, want in ((ga, a.grad), (gb, b.grad)):
        err = float((got - want).abs().max() / want.abs().max())
        assert 1e-4 < err < 0.2
