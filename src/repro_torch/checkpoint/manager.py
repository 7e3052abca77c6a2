"""Checkpoints of trees of torch tensors with atomic commits and an
asynchronous writer (``repro.checkpoint.manager``).

Layout, the reference's, file for file:

    <dir>/step_<N>/
        manifest.json          {"step": N, "leaves": {key: {file, shape, dtype}}}
        <leaf-path>.npy        one file per leaf (the full array)

* atomic commit: a step is written to ``step_<N>.tmp`` and renamed once
  its manifest is in, so a killed writer never leaves a half checkpoint
  that :meth:`CheckpointManager.restore` could pick up;
* ``save_async`` copies every leaf to the host at once (synchronously) and
  writes the files in a daemon thread; ``wait`` joins it, and every save
  waits for the one before;
* ``keep`` checkpoints are kept, the oldest removed after each commit;
* a mesh's sharded leaves (:class:`~repro_torch.launch.mesh.Sharded`) are
  saved whole, so the files do not depend on the mesh, and restore onto
  any mesh: a sharded template leaf onto its own mesh and spec, or each
  leaf onto ``shardings`` (a matching tree of
  :class:`~repro_torch.launch.mesh.NamedSharding`), the reference's
  elastic restore.

bfloat16 leaves are stored as the reference's ``np.save`` of an
``ml_dtypes.bfloat16`` array stores them, as raw 2-byte void (``<V2``)
with ``"bfloat16"`` as the manifest's dtype, and read back through an
int16 view, so neither package needs ``ml_dtypes`` for the other's files
and each restores the other's checkpoints bit for bit.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.launch.mesh import NamedSharding, Sharded, gather_array, shard_array

BF16 = "bfloat16"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(template: Any, flat: dict[str, Any], prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if hasattr(template, "_fields"):
        vals = {k: _unflatten(getattr(template, k), flat, f"{prefix}{k}/") for k in template._fields}
        return type(template)(**vals)
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, flat, f"{prefix}{i}/") for i, v in enumerate(template))
    return flat[prefix.rstrip("/")]


def _at(tree: Any, key: str) -> Any:
    """The node of ``tree`` at a flattened leaf's key (the template's
    path, so a partition spec, a tuple, stays one node); None under a
    None subtree (no sharding for those leaves)."""
    for k in key.split("/"):
        if tree is None:
            return None
        if isinstance(tree, dict):
            tree = tree[k]
        elif hasattr(tree, "_fields"):
            tree = getattr(tree, k)
        else:
            tree = tree[int(k)]
    return tree


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A copy of a leaf on the host and its manifest dtype; bfloat16 as
    int16 bits.  A leaf that is not a tensor is stored as ``np.asarray``
    of it, as the reference stores every leaf."""
    if isinstance(leaf, Sharded):
        t = gather_array(leaf, "cpu")
    elif not isinstance(leaf, torch.Tensor):
        arr = np.array(leaf)
        return arr, str(arr.dtype)
    else:
        t = leaf.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _save(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    # the header np.save writes for an ml_dtypes.bfloat16 array
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {"descr": "<V2", "fortran_order": False,
                                                 "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _load(path: pathlib.Path, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if arr.dtype.kind == "V":
        # extended dtypes survive np.save only as raw void bytes; the
        # manifest remembers which they were
        if dtype != BF16 or arr.dtype.itemsize != 2:
            raise ValueError(f"{path.name}: cannot read a {dtype} leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any) -> pathlib.Path:
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        return self._write(step, host)

    def save_async(self, step: int, tree: Any) -> None:
        """Copy every leaf to the host now, then write the files in a
        thread; the device may overwrite the leaves once this returns."""
        self.wait()
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: dict[str, tuple[np.ndarray, str]]) -> pathlib.Path:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {}
        for key, (arr, dtype) in host.items():
            fn = key.replace("/", "__") + ".npy"
            _save(tmp / fn, arr, dtype)
            manifest[key] = {"file": fn, "shape": list(arr.shape), "dtype": dtype}
        (tmp / "manifest.json").write_text(json.dumps({"step": step, "leaves": manifest}))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp") and (p / "manifest.json").exists()
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, *, step: int | None = None, shardings: Any = None,
                device: str | torch.device | None = None) -> tuple[int, Any]:
        """Restore step ``step`` (default: the latest) into the structure of
        ``template``: each leaf a new tensor on ``device``, or on its
        template leaf's device; a leaf with a :class:`NamedSharding` in
        ``shardings`` (a matching tree) is placed as that mesh's shards
        (the elastic-rescale path: saved from mesh A, restored on mesh B),
        and a sharded template leaf without one as the template's."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:08d}"
        manifest = json.loads((path / "manifest.json").read_text())["leaves"]
        loaded = {}
        for key, leaf in _flatten(template).items():
            meta = manifest[key]
            arr = _load(path / meta["file"], meta["dtype"])
            target = None if shardings is None else _at(shardings, key)
            if target is None and isinstance(leaf, Sharded):
                target = NamedSharding(leaf.mesh, leaf.spec)
            if target is not None:
                if not isinstance(target, NamedSharding):
                    raise TypeError(f"{key}: a restore sharding is a NamedSharding, not {type(target).__name__}")
                loaded[key] = shard_array(arr, target)
            else:
                dev = device if device is not None else getattr(leaf, "device", "cpu")
                loaded[key] = arr.to(dev)
        return step, _unflatten(template, loaded)
