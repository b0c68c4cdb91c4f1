"""Atomic checkpoints in the reference's on-disk format (its
``checkpoint/checkpoint.py``): a checkpoint written by either package
restores in the other.

  * One raw-bytes file a leaf, named by the leaf's path with ``/`` as
    ``__`` plus ``.bin``, and ``manifest.json`` holding each leaf's
    file, shape and dtype string, the step and a JSON ``extra``.
  * Leaf paths as the reference's pytree paths: dict keys sorted and
    joined by ``/``, NamedTuple fields by name, list items by index
    (``params/attn/wq``, ``opt/step``, ``opt/m/...``).
  * A step is written under ``<step>.tmp.*``, every file fsynced, then
    renamed into place: a crash never leaves a partial step visible.
  * Keep-N GC that also removes stale tmp directories.
  * Restore into a target tree: each shape checked, each leaf cast to
    the target's dtype and placed on ``device``.

bf16 leaves cross as their uint16 bits under the manifest dtype
"bfloat16" (numpy has no bfloat16 without ``ml_dtypes``). Restoring
onto a sharded mesh (the reference's ``shardings``) waits for ROADMAP
#16.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device


def _leaf_paths(tree, prefix=()):
    """[(path string, leaf)] in the reference's flatten order; None is
    an empty subtree, as in a pytree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [("/".join(prefix) or "_root", tree)]
    return [pl for k, x in items for pl in _leaf_paths(x, prefix + (k,))]


def _rebuild(tree, it):
    """``tree``'s structure with its leaves drawn from ``it``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), it)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, it) for x in tree)
    return next(it)


def _fname(leaf_path: str) -> str:
    return leaf_path.replace("/", "__") + ".bin"


def _to_numpy(leaf):
    """(host array of the leaf's bytes, manifest dtype string)."""
    t = torch.as_tensor(leaf).detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy(), "bfloat16"
    a = t.cpu().numpy()
    return a, a.dtype.name


def _read_leaf(path, dtype: str, shape):
    """A leaf's file as a CPU tensor (bf16 from its uint16 bits)."""
    bf16 = dtype == "bfloat16"
    a = np.fromfile(path, dtype=np.uint16 if bf16 else dtype).reshape(shape)
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if bf16 else t


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- discovery ---------------------------------------------------------
    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if (name.isdigit() and os.path.isdir(full)
                    and os.path.exists(os.path.join(full, "manifest.json"))):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, *, extra: Optional[dict] = None):
        """Atomic save of ``tree`` at ``step``. ``extra``: JSON metadata
        (data-pipeline index, ...)."""
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            shutil.rmtree(final)
        tmp = tempfile.mkdtemp(prefix=f"{step}.tmp.", dir=self.directory)
        try:
            manifest = {"step": step, "extra": extra or {}, "leaves": {}}
            for path, leaf in _leaf_paths(tree):
                arr, dtype = _to_numpy(leaf)
                fn = _fname(path)
                with open(os.path.join(tmp, fn), "wb") as f:
                    f.write(memoryview(np.ascontiguousarray(arr)).cast("B"))
                    f.flush()
                    os.fsync(f.fileno())
                manifest["leaves"][path] = {
                    "file": fn, "shape": list(arr.shape), "dtype": dtype}
            mpath = os.path.join(tmp, "manifest.json")
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, final)          # atomic publish
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, str(s)),
                          ignore_errors=True)
        # stale tmp dirs from crashed saves
        for name in os.listdir(self.directory):
            if ".tmp." in name:
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def restore(self, step: int, target_tree, *, device=None,
                shardings: Any = None, strict: bool = True):
        """Restore into the structure of ``target_tree`` (shapes checked,
        each leaf cast to the target leaf's dtype) on ``device`` (None:
        CUDA). Returns (tree, extra)."""
        if shardings is not None:
            raise ValueError("restoring onto shardings needs a device mesh: "
                             "the sharding tooling waits for ROADMAP #16")
        dev = resolve_device(device)
        d = os.path.join(self.directory, str(step))
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        out = []
        for path, ref in _leaf_paths(target_tree):
            meta = manifest["leaves"].get(path)
            if meta is None:
                if strict:
                    raise KeyError(f"checkpoint {step} missing leaf {path}")
                out.append(ref)
                continue
            t = _read_leaf(os.path.join(d, meta["file"]), meta["dtype"],
                           meta["shape"])
            want = tuple(ref.shape) if hasattr(ref, "shape") else None
            if want is not None and tuple(t.shape) != want:
                raise ValueError(
                    f"leaf {path}: checkpoint shape {tuple(t.shape)} != "
                    f"{want}")
            dt = ref.dtype if torch.is_tensor(ref) else t.dtype
            out.append(t.to(device=dev, dtype=dt))
        return _rebuild(target_tree, iter(out)), manifest["extra"]

    def restore_latest(self, target_tree, **kw):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, target_tree, **kw)
        return step, tree, extra
