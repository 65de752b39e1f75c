"""What the harness, the drivers and the metric readers share: the checkout's
layout, loading a piece by its name, spans, the card check, and the check
that nothing of JAX or of the JAX package was loaded."""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Iterator

#: the benchmark's folder and the checkout it lies in
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that may not be loaded in a measuring process
#: (whole names: ``repro_torch`` is the port, ``repro`` the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, an unknown name, a
    forbidden module); the harness exits non-zero and prints nothing."""


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_piece(kind: str, name: str, root: Path = ROOT) -> ModuleType:
    """``cxlbench/<kind>/<name>.py`` as a module (names may hold dots, so
    the file is loaded by path, not imported by name).  A dotted name
    with no file of its own is read by its family's: ``a.b.c`` falls back
    to ``a.b`` and then to ``a``, so one reader serves the same quantity
    split by cell (``idle_share.dlrm``, ``idle_share.train``)."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = root / "cxlbench" / kind / (".".join(parts[:n]) + ".py")
        if path.is_file():
            break
    else:
        raise BenchError(f"no {kind[:-1]} named {name!r} "
                         f"(nor any of its family) under cxlbench/{kind}")
    stem = path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"cxlbench_{kind}_{stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_value(values: dict, name: str):
    """``values[name]``, or its family's value as :func:`load_piece` finds
    a reader (``train_tokens_per_s.fused`` reads ``train_tokens_per_s``);
    None where there is neither."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        key = ".".join(parts[:n])
        if key in values:
            return values[key]
    return None


def forbidden_loaded(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def use_program(root: Path = ROOT) -> None:
    """Put the checkout's ``src`` (the port, ``repro_torch``) on the path."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    #: whether a profiler was tracing while the span ran
    profiled: bool

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Spans:
    """Host spans around the calls into the program's layers, kept in
    memory.  Off (``enabled=False``) a span costs one branch; on, two
    reads of the host clock, and while a profiler traces, a
    ``record_function`` marker of the same name in its trace."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.profiling = False
        self.items: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if not self.enabled:
            yield
            return
        marker = contextlib.nullcontext()
        if self.profiling:
            import torch
            marker = torch.profiler.record_function(name)
        with marker:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.items.append(Span(name, t0, time.perf_counter(),
                                       self.profiling))

    def of(self, name: str) -> list[Span]:
        """Spans named ``name`` of the untraced stretch (the profiler's
        own cost left out)."""
        return [s for s in self.items if s.name == name and not s.profiled]


def synchronize(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generator(seed: int, stream: int, device):
    """A ``torch.Generator`` on ``device`` for input stream ``stream`` of
    run ``seed``: streams are independent, so each input can be made
    again alone (the reference does) without drawing the others."""
    import torch
    mixed = (int(seed) * 1_000_003 + int(stream) * 7_919) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)
