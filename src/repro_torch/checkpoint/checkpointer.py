"""Sharded, async, integrity-checked checkpointing.

Layout (the reference's): ``<dir>/step_<N>/`` with one ``.npy`` per leaf
(keyed by :func:`repro_torch.tree.keystr` of its path, the reference's
``jax.tree_util.keystr``) plus ``index.json`` carrying shapes, dtypes,
crc32 digests and user metadata.  Writes run on a background thread
against host snapshots so the train loop never blocks; ``restore``
verifies digests.  ``keep`` bounds retained checkpoints.

numpy has no bfloat16: a bf16 leaf is stored as its raw ``uint16`` bits,
its index entry naming ``bfloat16``, and restores bit-exact.  ``restore``
writes into the template's tensors in place (under ``torch.no_grad()``),
so parameters and optimizer state keep their storage; numpy and Python
leaves come back as new values.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import flatten, keystr, rebuild


def _snapshot(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name) of a leaf, copied to the host."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _flatten(tree) -> dict:
    return {keystr(p): v for p, v in flatten(tree)}


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3, asynchronous: bool = True):
        self.directory = directory
        self.keep = keep
        self.asynchronous = asynchronous
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, metadata: Optional[dict] = None) -> None:
        self.wait()
        # Snapshot to host memory synchronously (cheap vs. disk I/O).
        flat = {k: _snapshot(v) for k, v in _flatten(tree).items()}
        meta = dict(metadata or {})
        if self.asynchronous:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, meta), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, flat, meta)

    def _write(self, step: int, flat: dict, meta: dict) -> None:
        try:
            tmp = os.path.join(self.directory, f".tmp_step_{step}")
            final = os.path.join(self.directory, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            index = {"step": step, "metadata": meta, "leaves": {}}
            for i, (key, (arr, dtype)) in enumerate(sorted(flat.items())):
                fname = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fname), arr)
                index["leaves"][key] = {
                    "file": fname,
                    "shape": list(arr.shape),
                    "dtype": dtype,
                    "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
                }
            with open(os.path.join(tmp, "index.json"), "w") as f:
                json.dump(index, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.available_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def available_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                out.append(int(name.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.available_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None
                ) -> tuple[int, Any, dict]:
        """Restore into the structure of ``template``; verifies digests."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        loaded = {}
        for key, info in index["leaves"].items():
            arr = np.load(os.path.join(d, info["file"]))
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if crc != info["crc32"]:
                raise IOError(f"checkpoint corruption in {key}")
            loaded[key] = (arr, info["dtype"])
        values = {}
        for p, tmpl in flatten(template):
            key = keystr(p)
            if key not in loaded:
                raise KeyError(f"missing leaf {key} in checkpoint")
            arr, dtype = loaded[key]
            if isinstance(tmpl, torch.Tensor):
                host = torch.from_numpy(arr.copy())
                if dtype == "bfloat16":
                    host = host.view(torch.bfloat16)
                with torch.no_grad():
                    tmpl.copy_(host.reshape(tmpl.shape))
                values[p] = tmpl
            elif hasattr(tmpl, "dtype"):
                values[p] = np.asarray(arr).astype(tmpl.dtype)
            else:
                values[p] = arr
        return step, rebuild(template, values), index["metadata"]
