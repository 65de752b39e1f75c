"""Kernel plumbing: building the CUDA sources, loading them, counting launches.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, from the checkout's sources only, into
``build/repro_torch/`` beside ``src/`` (listed in ``.gitignore``); the
library's file name carries a hash of the source and flags, so an edited
source rebuilds and an unchanged one is reused.  ``build`` starts one
``nvcc`` per source, all at once.

Wrappers launch on PyTorch's current stream, never synchronise, and
raise when the launch reports an error.  They take the plain PyTorch
version only for tensors that lie on the CPU.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
KERNELS = ("embedding_reduce", "stream_copy", "decode_attention", "wkv6",
           "memo_probe")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """Kernel launches since the last reset (the main-path probe)."""

    __slots__ = ("count",)

    def __init__(self) -> None:
        self.count = 0

    def bump(self, n: int = 1) -> None:
        self.count += n

    def reset(self) -> int:
        out, self.count = self.count, 0
        return out


class HostHold:
    """Host tensors that queued kernels read or write in place (pinned
    memory, through unified addressing), each kept alive until an event
    recorded after its launch has completed.

    PyTorch's caching host allocator does not see such kernel accesses:
    a pinned block freed while a launch that reads it is still queued goes
    straight back to the pool, and the next ``pin_memory()`` may get it
    and overwrite it from the host before the kernel has read it.  Holds
    are released oldest first, at the next :meth:`keep` or
    :meth:`release`."""

    def __init__(self) -> None:
        self._held: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._held)

    def keep(self, tensors: Iterable[torch.Tensor], event) -> None:
        """Hold ``tensors`` until ``event`` (a ``torch.cuda.Event``
        recorded after the launch, or anything with ``query()``) has
        completed."""
        tensors = tuple(tensors)
        with self._lock:
            self._release()
            if tensors:
                self._held.append((event, tensors))

    def keep_launched(self, tensors: Iterable[torch.Tensor],
                      device: torch.device) -> None:
        """Hold the host tensors among ``tensors`` until the launch just
        queued on ``device``'s current stream has run."""
        host = [t for t in tensors if not t.is_cuda]
        if host:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            self.keep(host, event)

    def release(self) -> None:
        """Drop every hold whose launch has completed, oldest first."""
        with self._lock:
            self._release()

    def _release(self) -> None:
        while self._held and self._held[0][0].query():
            self._held.popleft()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns each new build's ``nvcc``
    output (the ``-Xptxas -v`` register and spill report)."""
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {}
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def card_device(*tensors: torch.Tensor, device=None) -> Optional[torch.device]:
    """The CUDA device a kernel call runs on, or None for a CPU call.

    A call is on the card when any tensor is on CUDA or in pinned host
    memory; with host tensors only it runs on ``device`` if that names a
    card, else on the current one.  Its host tensors must be page-locked,
    which the kernels reach through unified virtual addressing.  Unpinned
    host memory next to a CUDA tensor is an error, not a reason to fall
    back."""
    cuda = [t.device for t in tensors if t.is_cuda]
    if not cuda and any(t.is_pinned() for t in tensors):
        dev = torch.device("cuda" if device is None else device)
        if dev.type != "cuda":
            raise ValueError(f"pinned host tensors run on a card, not {dev}")
        cuda = [dev if dev.index is not None
                else torch.device("cuda", torch.cuda.current_device())]
    if not cuda:
        return None
    if any(d != cuda[0] for d in cuda):
        raise ValueError(f"tensors on several CUDA devices: {set(cuda)}")
    for t in tensors:
        if not t.is_cuda and not t.is_pinned():
            raise ValueError(
                "a host tensor passed to a CUDA kernel must be pinned "
                "(page-locked); got pageable host memory")
    return cuda[0]


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"kernel supports float32 and bfloat16, got {dtype}")
    return DTYPE_CODES[dtype]
