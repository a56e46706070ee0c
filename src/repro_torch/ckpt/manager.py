"""Checkpointing: asynchronous and atomic (port of ``repro.ckpt.manager``).

Layout:  <dir>/step_<N>/{manifest.json, leaf_<i>.npy ...}
Commit protocol: write into ``step_<N>.tmp``, fsync the manifest, rename:
a crash mid-save never corrupts the latest checkpoint.  Saves run on a
background thread while training goes on; an error there is raised at the
next ``wait()`` (or ``save``).  ``wait()`` joins before exit.

A state is a nested dict of tensors (or numpy arrays).  Its leaves are
flattened with every dict's keys sorted, as ``jax.tree_util`` flattens
the reference's trees, and the manifest names each leaf by the
reference's key-path string, so a checkpoint of the same nested dict of
float32 and int32 arrays restores in either package.  numpy has no
bfloat16: a bf16 leaf is stored as its uint16 bits, its dtype recorded
in the manifest's ``dtypes``, and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def flatten(tree, path=()) -> list:
    """[(key path, leaf)] with dict keys sorted, ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k], path + (k,))]
    return [(path, tree)]


def unflatten(like, leaves: list):
    """``like``'s nested dicts with its leaves replaced, in ``flatten`` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(like)


def _key_string(path: tuple) -> str:
    """The reference's ``str`` of a ``jax.tree_util`` key path."""
    return str(tuple(_DictKey(k) for k in path))


class _DictKey(str):
    def __repr__(self) -> str:
        return f"DictKey(key={str.__repr__(self)})"


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (never a view: the caller may update the
    tensor in place while the save thread writes)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.array(leaf)


@dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, *, blocking: bool = False):
        """Write ``state`` as step ``step``.  The device-to-host copy is
        taken here, before the write thread starts."""
        self.wait()
        flat = flatten(state)
        host = [_to_host(leaf) for _, leaf in flat]
        keys = [_key_string(p) for p, _ in flat]
        dtypes = {str(i): "bfloat16" for i, (_, leaf) in enumerate(flat)
                  if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16}

        def _write():
            try:
                tmp = os.path.join(self.directory, f"step_{step}.tmp")
                final = os.path.join(self.directory, f"step_{step}")
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                manifest = {"step": step, "n_leaves": len(host), "keys": keys, "time": time.time()}
                if dtypes:
                    manifest["dtypes"] = dtypes
                for i, arr in enumerate(host):
                    np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    os.fsync(f.fileno())
                shutil.rmtree(final, ignore_errors=True)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:  # raised at the next wait()
                self._error = e

        if blocking:
            _write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {e}") from e

    def _gc(self):
        for s in self.all_steps()[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like):
        """Restore into the structure of ``like`` (values ignored): each
        tensor leaf comes back on ``like``'s leaf's device in its dtype,
        each numpy leaf as a numpy array of its dtype."""
        d = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = flatten(like)
        if manifest["n_leaves"] != len(flat):
            raise ValueError(f"checkpoint step {step} holds {manifest['n_leaves']} leaves, the state {len(flat)}:"
                             " the tree structure changed")
        bf16 = manifest.get("dtypes", {})
        out = []
        for i, (_, ref) in enumerate(flat):
            arr = np.load(os.path.join(d, f"leaf_{i}.npy"))
            if isinstance(ref, torch.Tensor):
                t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) if bf16.get(str(i)) == "bfloat16"
                     else torch.from_numpy(arr))
                out.append(t.to(device=ref.device, dtype=ref.dtype))
            else:
                ref_dtype = getattr(ref, "dtype", None)
                out.append(arr.astype(ref_dtype) if ref_dtype is not None and arr.dtype != ref_dtype else arr)
        return unflatten(like, out)
