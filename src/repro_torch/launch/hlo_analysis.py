"""Post-SPMD HLO cost analyzer with while-loop trip-count correction.

``compiled.cost_analysis()`` counts each scan/while body ONCE, which
undercounts a 64-layer scanned transformer by ~64x.  This analyzer
parses ``compiled.as_text()`` (the per-device partitioned module):

* computations are classified (entry / while body / fusion-inlined) and
  each gets a multiplier = product of enclosing loop trip counts (trip
  counts recovered from the ROOT compare constant of while conds);
* FLOPs: 2 x result x contracted-dim product for every ``dot`` (+conv),
  scaled by the multiplier — matmul flops are >95% of these models;
* HBM bytes: post-fusion top-level op I/O (operands + results of
  fusions, dots, copies, gathers/scatters, dynamic slices,
  collectives), scaled by multipliers — fusion internals are free, and
  loop-body intermediates smaller than ``VMEM_RESIDENT_BYTES`` are
  excluded (a TPU pipelines them through VMEM without an HBM
  round-trip), so this models TPU HBM traffic, fusion-optimistically;
* collective wire bytes per device, per op kind, with ring-cost
  formulas and ICI/DCN classification from decoded replica groups.

The port keeps this analyzer as it is (pure Python over ``re`` and
numpy) and adds a second front end for its own programs, which have no
HLO: :func:`costs_of` runs a step on fake tensors and fills the same
:class:`HloCosts` record.
"""
from __future__ import annotations

import dataclasses
import re
import weakref
from collections import defaultdict
from typing import Optional

import numpy as np
import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "ragged-all-to-all")

# Ops that do HBM I/O even under TPU-grade fusion.  The XLA:CPU module
# this analyzer reads is much less fused than the TPU module would be
# (standalone converts/broadcasts everywhere), so elementwise ops are
# EXCLUDED: on TPU they fuse into their consumers.  The resulting memory
# term is a fusion-optimistic estimate of TPU HBM traffic (documented in
# EXPERIMENTS.md §Roofline methodology).
_BYTE_OPS = {
    "fusion", "dot", "convolution", "copy", "gather", "scatter",
    "dynamic-slice", "dynamic-update-slice", "sort", "custom-call",
} | set(_COLLECTIVES) | {c + "-start" for c in _COLLECTIVES}

# Loop-body values at or below this size are assumed VMEM-resident on TPU
# (v5e: 128 MiB VMEM; leave headroom for double-buffering).
VMEM_RESIDENT_BYTES = 48 * 1024 * 1024


@dataclasses.dataclass
class Shape:
    dtype: str
    dims: tuple[int, ...]

    @property
    def bytes(self) -> int:
        return _DTYPE_BYTES.get(self.dtype, 4) * int(np.prod(self.dims)) \
            if self.dims else _DTYPE_BYTES.get(self.dtype, 4)

    @property
    def elems(self) -> int:
        return int(np.prod(self.dims)) if self.dims else 1


def parse_type(s: str) -> list[Shape]:
    """'bf16[8,2]{1,0}' or '(f32[], bf16[4])' -> list of Shapes."""
    out = []
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", s):
        dims = tuple(int(d) for d in m.group(2).split(",") if d)
        out.append(Shape(m.group(1), dims))
    return out


@dataclasses.dataclass
class Op:
    name: str
    kind: str
    result: list[Shape]
    operands: list[str]
    attrs: str
    comp: str
    raw_operands: str = ""


@dataclasses.dataclass
class Computation:
    name: str
    ops: dict[str, Op]
    is_entry: bool = False


_HEADER = re.compile(r"^(ENTRY\s+)?%?([\w\.\-]+)\s*\(.*\)\s*->")
_OP_LINE = re.compile(r"^\s+(?:ROOT\s+)?%([\w\.\-]+)\s*=\s*(.*)$")


def _split_type_and_rest(rest: str) -> tuple[str, str]:
    """Split 'TYPE kind(operands), attrs' at the op kind boundary."""
    rest = rest.strip()
    if rest.startswith("("):
        depth = 0
        for i, ch in enumerate(rest):
            depth += ch == "("
            depth -= ch == ")"
            if depth == 0:
                return rest[: i + 1], rest[i + 1:].strip()
    i = rest.find(" ")
    return rest[:i], rest[i + 1:].strip()


def parse_module(text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in text.splitlines():
        if not line.startswith(" ") and _HEADER.match(line) and line.rstrip().endswith("{"):
            m = _HEADER.match(line)
            cur = Computation(m.group(2), {}, is_entry=bool(m.group(1)))
            comps[cur.name] = cur
            continue
        if line.strip() == "}":
            continue
        m = _OP_LINE.match(line)
        if not m or cur is None:
            continue
        name, rest = m.group(1), m.group(2)
        type_str, tail = _split_type_and_rest(rest)
        km = re.match(r"([\w\-]+)\(", tail)
        if not km:
            continue
        kind = km.group(1)
        # operand list: up to matching close paren
        depth, start = 0, tail.find("(")
        end = start
        for i in range(start, len(tail)):
            depth += tail[i] == "("
            depth -= tail[i] == ")"
            if depth == 0:
                end = i
                break
        operand_str = tail[start + 1: end]
        attrs = tail[end + 1:]
        operands = re.findall(r"%([\w\.\-]+)", operand_str)
        cur.ops[name] = Op(name, kind, parse_type(type_str), operands, attrs,
                           cur.name, operand_str)
    return comps


def _trip_count(cond: Computation) -> int:
    """Trip count from the cond's compare-vs-constant (scan convention)."""
    m = re.findall(r"constant\((\d+)\)", _comp_text(cond))
    if m:
        return max(int(x) for x in m)
    return 1


def _comp_text(comp: Computation) -> str:
    return " ".join(
        f"{op.kind}({op.raw_operands}) {op.attrs}" for op in comp.ops.values()
    )


def _attr_comp_refs(op: Op) -> dict[str, list[str]]:
    refs = defaultdict(list)
    for key in ("condition", "body", "calls", "to_apply"):
        for m in re.finditer(key + r"=%?([\w\.\-]+)", op.attrs):
            refs[key].append(m.group(1))
    m = re.search(r"branch_computations=\{([^}]*)\}", op.attrs)
    if m:
        refs["branches"] = re.findall(r"%?([\w\.\-]+)", m.group(1))
    return refs


def decode_replica_groups(attrs: str, n_devices: int) -> list[list[int]]:
    m = re.search(r"replica_groups=\{\{([\d,{} ]*)\}\}", attrs)
    if m:
        return [[int(x) for x in g.split(",") if x.strip()]
                for g in m.group(1).split("},{")]
    m = re.search(
        r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?", attrs)
    if m:
        g, s = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        arr = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(4):
            arr = arr.transpose([int(x) for x in m.group(4).split(",")])
        return arr.reshape(g, s).tolist()
    # default: one group of everything
    return [list(range(n_devices))]


@dataclasses.dataclass
class CollectiveRecord:
    kind: str
    comp: str
    multiplier: int
    group_size: int
    operand_bytes: int  # per device
    wire_bytes: int  # per device, x multiplier applied
    link: str  # "ici" | "dcn"


@dataclasses.dataclass
class HloCosts:
    flops: float  # per device, loop-corrected
    hbm_bytes: float  # per device, loop-corrected (post-fusion op I/O)
    collectives: list[CollectiveRecord]
    n_devices: int
    #: most bytes of storage a traced step held at once beyond its
    #: arguments (:func:`costs_of`; 0 from HLO text)
    peak_bytes: float = 0.0

    def collective_bytes(self, link: Optional[str] = None) -> float:
        return sum(c.wire_bytes for c in self.collectives
                   if link is None or c.link == link)

    def collective_counts(self) -> dict[str, int]:
        out: dict[str, int] = defaultdict(int)
        for c in self.collectives:
            out[c.kind] += c.multiplier
        return dict(out)


def _wire_bytes(kind: str, operand_bytes: int, result_bytes: int, g: int) -> float:
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind.startswith("all-reduce"):
        return 2 * operand_bytes * frac
    if kind.startswith("all-gather"):
        return result_bytes * frac
    if kind.startswith("reduce-scatter"):
        return operand_bytes * frac
    if kind.startswith("all-to-all") or kind.startswith("ragged-all-to-all"):
        return operand_bytes * frac
    if kind.startswith("collective-permute"):
        return operand_bytes
    return operand_bytes


def analyze(text: str, *, n_devices: int, chips_per_pod: int = 256) -> HloCosts:
    comps = parse_module(text)
    entry = next(c for c in comps.values() if c.is_entry)

    # classify computations: multiplier per counted computation
    mult: dict[str, float] = {entry.name: 1.0}
    inlined: set[str] = set()
    stack = [entry.name]
    while stack:
        cname = stack.pop()
        comp = comps.get(cname)
        if comp is None:
            continue
        m = mult[cname]
        for op in comp.ops.values():
            refs = _attr_comp_refs(op)
            if op.kind == "while":
                cond = refs.get("condition", [None])[0]
                body = refs.get("body", [None])[0]
                trips = _trip_count(comps[cond]) if cond in comps else 1
                for sub in (body,):
                    if sub and sub in comps and sub not in mult:
                        mult[sub] = m * trips
                        stack.append(sub)
            elif op.kind in ("fusion",) or refs.get("calls"):
                for sub in refs.get("calls", []):
                    inlined.add(sub)
            elif op.kind == "conditional":
                for sub in refs.get("branches", []):
                    if sub in comps and sub not in mult:
                        mult[sub] = m
                        stack.append(sub)
            elif op.kind in ("call", "async-start"):
                for sub in refs.get("to_apply", []) + refs.get("calls", []):
                    if sub in comps and sub not in mult:
                        mult[sub] = m
                        stack.append(sub)

    def _lookup(o: str, comp: Computation) -> Optional[Op]:
        src = comp.ops.get(o)
        if src is None:
            for c2 in comps.values():
                if o in c2.ops:
                    return c2.ops[o]
        return src

    def operand_bytes(op: Op, comp: Computation) -> int:
        # Sliced reads only touch the slice, not the whole operand: a
        # dynamic-slice of the stacked (L, ...) layer weights inside a scan
        # reads ONE layer's worth per trip.
        if op.kind in ("dynamic-slice", "slice"):
            return sum(s.bytes for s in op.result)
        if op.kind == "dynamic-update-slice":
            upd = _lookup(op.operands[1], comp) if len(op.operands) > 1 else None
            return sum(s.bytes for s in upd.result) if upd else 0
        if op.kind == "gather":
            return sum(s.bytes for s in op.result)
        total = 0
        per_param_counts = None
        res_bytes = sum(s.bytes for s in op.result)
        if op.kind == "fusion":
            if _fusion_is_trivial(op):
                # convert/copy/broadcast-only fusions fuse into their
                # consumers on TPU: no standalone HBM pass.
                return -res_bytes  # cancel the result bytes counted later
            per_param_counts = _fusion_param_bytes(op)
        for i, o in enumerate(op.operands):
            if per_param_counts is not None and i in per_param_counts:
                total += per_param_counts[i]
                continue
            src = _lookup(o, comp)
            if src is not None:
                b = sum(s.bytes for s in src.result)
                if op.kind == "fusion":
                    # slice-heavy fusion bodies read a fraction of huge
                    # operands; cap at 4x the result size
                    b = min(b, 4 * res_bytes)
                total += b
        return total

    _TRIVIAL_OPS = {"convert", "bitcast", "copy", "transpose", "broadcast",
                    "reshape", "parameter", "constant", "iota", "multiply",
                    "add", "subtract", "divide", "select", "compare",
                    "maximum", "minimum", "exponential", "tanh", "negate",
                    "rsqrt", "sqrt", "and", "or", "not", "abs", "clamp",
                    "power", "log", "logistic", "floor", "sign",
                    "get-tuple-element", "tuple"}

    def operand_bytes_vmem_aware(op: Op, comp: Computation) -> int:
        if op.kind in ("dynamic-slice", "slice", "gather",
                       "dynamic-update-slice"):
            return operand_bytes(op, comp)
        total = 0
        res_bytes = sum(s.bytes for s in op.result)
        per_param_counts = None
        if op.kind == "fusion":
            if _fusion_is_trivial(op):
                return 0
            per_param_counts = _fusion_param_bytes(op)
        for i, o in enumerate(op.operands):
            if per_param_counts is not None and i in per_param_counts:
                total += per_param_counts[i]
                continue
            src = _lookup(o, comp)
            if src is None:
                continue
            b = sum(s.bytes for s in src.result)
            if src.comp == comp.name and b <= VMEM_RESIDENT_BYTES:
                continue  # loop-local, VMEM-resident
            if op.kind == "fusion":
                b = min(b, 4 * res_bytes)
            total += b
        return total

    def _fusion_is_trivial(op: Op) -> bool:
        refs = _attr_comp_refs(op)
        called = refs.get("calls", [None])[0]
        fc = comps.get(called)
        if fc is None:
            return False
        return all(o.kind in _TRIVIAL_OPS for o in fc.ops.values())

    def _fusion_param_bytes(op: Op) -> dict[int, int]:
        """Per-operand read bytes for a fusion whose body only SLICES some
        parameter (the scan-over-stacked-weights pattern)."""
        refs = _attr_comp_refs(op)
        called = refs.get("calls", [None])[0]
        fc = comps.get(called)
        if fc is None:
            return {}
        param_name_by_idx: dict[int, str] = {}
        for o in fc.ops.values():
            if o.kind == "parameter":
                m = re.match(r"\s*(\d+)", o.raw_operands)
                if m:
                    param_name_by_idx[int(m.group(1))] = o.name
        out: dict[int, int] = {}
        for idx, pname in param_name_by_idx.items():
            consumers = [o for o in fc.ops.values() if pname in o.operands]
            if consumers and all(o.kind in ("dynamic-slice", "slice", "gather")
                                 for o in consumers):
                out[idx] = sum(sum(s.bytes for s in o.result)
                               for o in consumers)
        return out

    flops = 0.0
    hbm = 0.0
    colls: list[CollectiveRecord] = []
    seen_done = set()
    for cname, m in mult.items():
        if cname in inlined:
            continue
        comp = comps[cname]
        for op in comp.ops.values():
            res_bytes = sum(s.bytes for s in op.result)
            if op.kind == "dot":
                lhs = comp.ops.get(op.operands[0])
                cdims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", op.attrs)
                csize = 1
                if lhs is not None and cdims and lhs.result:
                    dims = lhs.result[0].dims
                    for d in cdims.group(1).split(","):
                        if d:
                            csize *= dims[int(d)]
                out_elems = sum(s.elems for s in op.result)
                flops += m * 2.0 * out_elems * csize
            if op.kind == "convolution":
                flops += m * 2.0 * sum(s.elems for s in op.result)
            if op.kind in _BYTE_OPS:
                in_loop = m > 1
                rb = res_bytes
                if in_loop and not op.kind.startswith(tuple(_COLLECTIVES)):
                    ob = operand_bytes_vmem_aware(op, comp)
                    if res_bytes <= VMEM_RESIDENT_BYTES:
                        rb = 0
                    hbm += m * (rb + ob)
                else:
                    hbm += m * (rb + operand_bytes(op, comp))
            base = op.kind.replace("-start", "")
            if base.split(".")[0] in _COLLECTIVES or any(
                    op.kind.startswith(c) for c in _COLLECTIVES):
                if op.kind.endswith("-done"):
                    continue
                ob = operand_bytes(op, comp)
                if op.kind.startswith(("all-reduce-start", "all-gather-start")):
                    # start result duplicates operand in a tuple
                    res_bytes = res_bytes // 2
                groups = decode_replica_groups(op.attrs, n_devices)
                g = len(groups[0]) if groups else 1
                n_pods = 1
                for grp in groups[:8]:
                    pods = {d // chips_per_pod for d in grp}
                    n_pods = max(n_pods, len(pods))
                kind = next(c for c in _COLLECTIVES if op.kind.startswith(c))
                if n_pods <= 1:
                    colls.append(CollectiveRecord(
                        kind=kind, comp=cname, multiplier=int(m), group_size=g,
                        operand_bytes=ob,
                        wire_bytes=m * _wire_bytes(op.kind, ob, res_bytes, g),
                        link="ici",
                    ))
                else:
                    # hierarchical model: within-pod ring over g/n_pods chips
                    # on ICI, then a cross-pod phase of the same payload on DCN
                    g_in = max(g // n_pods, 1)
                    colls.append(CollectiveRecord(
                        kind=kind, comp=cname, multiplier=int(m), group_size=g_in,
                        operand_bytes=ob,
                        wire_bytes=m * _wire_bytes(op.kind, ob, res_bytes, g_in),
                        link="ici",
                    ))
                    colls.append(CollectiveRecord(
                        kind=kind, comp=cname, multiplier=int(m), group_size=n_pods,
                        operand_bytes=ob,
                        wire_bytes=m * _wire_bytes(op.kind, ob, res_bytes, n_pods),
                        link="dcn",
                    ))
    return HloCosts(flops=flops, hbm_bytes=hbm, collectives=colls,
                    n_devices=n_devices)


# ---------------------------------------------------------------------------
# The port's front end: a step traced on fake tensors
# ---------------------------------------------------------------------------
def costs_of(fn, *args, **kwargs) -> HloCosts:
    """The costs of ``fn(*args, **kwargs)``, traced under
    ``FakeTensorMode`` (nothing is allocated, no kernel runs): tensors
    already fake keep their mode, real ones are converted into a new one.

    * FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s count
      (matmuls, convolutions and attention, forward and backward).
    * HBM bytes: each non-view op's operand and result bytes, summed.
      That is eager traffic with no fusion, where the reference's count
      assumes TPU-grade fusion (elementwise ops free): the port's figure
      is the larger, an upper bound on what a fused program would move.
    * Peak: the most bytes of storage the step held at once beyond the
      storages it was given (each new storage added when an op makes it,
      subtracted when it is freed).
    * No collectives: one card.
    """
    mode = detect_fake_mode((args, kwargs))
    if mode is None:
        mode = FakeTensorMode()
        args, kwargs = pytree.tree_map_only(
            torch.Tensor, mode.from_tensor, (args, kwargs))
    with mode, FlopCounterMode(display=False) as flop_mode, \
            _Traffic() as traffic:
        fn(*args, **kwargs)
    return HloCosts(flops=float(flop_mode.get_total_flops()),
                    hbm_bytes=float(traffic.bytes), collectives=[],
                    n_devices=1, peak_bytes=float(traffic.peak))


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _Traffic(TorchDispatchMode):
    """The dispatch mode behind :func:`costs_of`'s bytes and peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = self.peak = 0
        self.owned: dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not outs:
            return out  # a metadata query (``prim.device``) moves nothing
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        given = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in given or key in self.owned:
                continue  # a view or an in-place result
            self.owned[key] = st.nbytes()
            self.live += self.owned[key]
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, key)
        return out

    def _freed(self, key: int) -> None:
        self.live -= self.owned.pop(key)
