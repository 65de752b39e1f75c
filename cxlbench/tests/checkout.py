"""A checkout of tiny cells for the CPU: the benchmark's own files, each
cell's configuration and traffic cut tiny (the same limits), and the port
under ``src``.

A cell's cuts are found by its names, as the harness finds its pieces:
``cxlbench/tests/tiny/configs/<config>.json`` and
``cxlbench/tests/tiny/traffic/<traffic>.json``, each merged over the file
it cuts.  A cut may set only keys that file already has, so it can shrink
a model or a mix but not swap it for another.  A cell whose cut is
missing or refused keeps no copy of that file in the checkout, so it
never runs at full size: :func:`run_tiny` raises with the reason.

Both ``conftest.py`` and the test modules import this module; where one
pytest run collects ``tests/`` too, ``from conftest import ...`` could
bind ``tests/conftest.py`` instead."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

#: where a tree keeps its cells' tiny cuts, relative to its root
TINY = Path("cxlbench/tests/tiny")
#: a checkout's record of the cuts it could not take, by cell
REFUSED = Path("tiny_cuts_refused.json")


class CutError(RuntimeError):
    """A cell's tiny cut is missing or sets a key its file does not
    have."""


def cut_path(kind: str, name: str) -> Path:
    """The cut of configuration or traffic ``name`` (``kind`` is
    ``configs`` or ``traffic``), relative to a tree's root."""
    return TINY / kind / f"{name}.json"


def load_cut(source: Path, kind: str, name: str) -> dict:
    """The cut itself, as its file holds it."""
    path = cut_path(kind, name)
    if not (source / path).is_file():
        raise CutError(f"no tiny cut {path} for {kind} {name!r}: add it "
                       "before the cell can run on the CPU")
    return json.loads((source / path).read_text())


def tiny(source: Path, kind: str, name: str, full: dict) -> dict:
    """``full`` with its cut merged over it."""
    cut = load_cut(source, kind, name)
    unknown = sorted(set(cut) - set(full))
    if unknown:
        raise CutError(f"tiny cut {cut_path(kind, name)} sets {unknown}, "
                       f"which {kind} {name!r} does not have: a cut shrinks "
                       "what its file holds")
    return {**full, **cut}


def make_checkout(dest: Path, source: Path = ROOT) -> Path:
    """A checkout at ``dest`` of the tree at ``source`` (its
    ``BENCHMARK.json`` and ``cxlbench``) whose cells are cut tiny."""
    shutil.copytree(source / "cxlbench", dest / "cxlbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "src").symlink_to(ROOT / "src")
    bench = json.loads((source / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    refused: dict = {}
    for cell in bench["workloads"]:
        for kind, name, rel in (
                ("configs", cell["config"], files[cell["config"]]),
                ("traffic", cell["traffic"],
                 f"cxlbench/traffic/{cell['traffic']}.json")):
            try:
                cut = tiny(source, kind, name,
                           json.loads((source / rel).read_text()))
            except CutError as e:
                refused.setdefault(cell["name"], []).append(str(e))
                (dest / rel).unlink(missing_ok=True)
                continue
            (dest / rel).write_text(json.dumps(cut))
    (dest / REFUSED).write_text(json.dumps(refused))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


def run_tiny(root: Path, cell: str, seed: int = 7, trace: bool = False,
             device: str = "cpu", overrides=None, seconds: float = 0.3):
    """(result, checks) of one run of ``cell``'s tiny copy in checkout
    ``root``; a cell whose cuts were not taken raises :class:`CutError`
    and does not run."""
    from cxlbench import harness
    reasons = json.loads((root / REFUSED).read_text()).get(cell)
    if reasons:
        raise CutError(f"cell {cell!r}: " + "; ".join(reasons))
    return harness.run_cell(cell, seed, seconds, trace,
                            t_start=time.perf_counter(), root=root,
                            device=device, overrides=overrides)
