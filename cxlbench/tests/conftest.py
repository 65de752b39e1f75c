"""Fixtures of the benchmark's tests: a checkout of tiny cells for the CPU
(``checkout.py``), one run of a cell there, and the card."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

from checkout import make_checkout, run_tiny as run_in


@pytest.fixture(autouse=True)
def _keep_sys_path():
    """A run puts its checkout's ``src`` on ``sys.path``; take it off
    again, so that later test files in the same worker import nothing
    from a temporary checkout."""
    saved = list(sys.path)
    yield
    sys.path[:] = saved


@pytest.fixture(scope="session")
def checkout(tmp_path_factory) -> Path:
    return make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def run_tiny(checkout):
    """``run_tiny(cell, seed=7, trace=False, root=checkout, device="cpu",
    overrides=None, seconds=0.3)`` -> (result, checks) of one tiny run."""
    def run(cell, seed=7, trace=False, root=None, device="cpu",
            overrides=None, seconds=0.3):
        return run_in(root or checkout, cell, seed, trace, device,
                      overrides, seconds)
    return run


@pytest.fixture
def card():
    """The card, where there is one; the test skips without it."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
