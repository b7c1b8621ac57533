"""Checkpointing in the reference package's on-disk layout: the port of
``train/checkpoint.py`` for one process.

* A checkpoint of step N is the directory ``step_{N:010d}/`` holding
  ``host_00000.npz`` (every leaf as ``<key>::full``) and
  ``manifest_00000.json`` ({"step", "extra", "n_hosts", "leaves": {key:
  {"shape", "dtype", "sharded": false}}}).  A key is the leaf's path in
  the reference's pytree, its parts joined by ``/`` in the reference's
  flatten order (``models/tree.py``): a ``Stack`` (a block parameter held
  a group at a time) is written as ONE stacked array, as the reference
  stacks it.  So a float32 or int32 checkpoint written by either package
  restores in the other.
* NumPy has no bfloat16: the port stores a bfloat16 leaf as its uint16
  bits with ``"dtype": "bfloat16"`` in the manifest, and reads a bfloat16
  leaf back from its 16 bits, whether the port wrote them so or the
  reference wrote them through ``ml_dtypes``' bfloat16 type.
* Writes go to ``step_<N>.tmp-<nonce>/``, are fsynced and published by an
  atomic rename: a crashed writer never leaves a torn checkpoint.
* ``CheckpointManager`` keeps the newest K checkpoints and writes on a
  background thread after a synchronous snapshot to host memory.

* Over a mesh (``parallel.api.ctx().mesh``, or ``mesh=``) each rank holds
  its shard of a leaf (the leaf's ``spec``: a parameter's, an optimizer
  moment's).  ``save`` gathers the shards to rank 0, which writes one
  entry a distinct shard, ``<key>::<index>`` with the reference's
  ``_index_id`` names ("start-stop" a dimension, joined by "_"; replicas
  written once) and ``"sharded": true``; a replicated leaf is written
  ``::full``.  Every rank takes part, and returns once the checkpoint is
  published.
* ``restore(..., shardings=, mesh=)`` re-shards onto **any** mesh (the
  elastic restore): each rank assembles only its own shard under the
  given specs (by default each like-leaf's ``spec``) from the entries
  that overlap it, whatever mesh wrote them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.tree import Stack, flatten
from repro_torch.parallel import api as par
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import sharding as shard_rules

SEP = "/"


class Stager:
    """Copies between the card and pageable host memory through one pinned
    buffer of ``chunk`` bytes, allocated at first use: a direct copy from a
    pageable host array ran at about 1 GB/s on an H100 80GB HBM3's host
    (16.4 s for mamba2-1.3b's 16.1 GB of float32 params, m and v; 9.9 s
    staged)."""

    def __init__(self, chunk: int = 1 << 28):
        self.chunk = chunk
        self.buf = None

    def _copy(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """dst ← src, both contiguous, of the same bytes, one on the card."""
        if self.buf is None:
            self.buf = torch.empty(self.chunk, dtype=torch.uint8, pin_memory=True)
        d, s = dst.reshape(-1).view(torch.uint8), src.reshape(-1).view(torch.uint8)
        for i in range(0, d.numel(), self.chunk):
            n = min(self.chunk, d.numel() - i)
            self.buf[:n].copy_(s[i:i + n])
            d[i:i + n].copy_(self.buf[:n])

    def to_host(self, t: torch.Tensor) -> np.ndarray:
        """A host copy of ``t``, which a later in-place update does not
        reach; bfloat16 as its uint16 bits."""
        t = t.detach()
        bf16 = t.dtype == torch.bfloat16
        t = t.view(torch.int16) if bf16 else t
        if t.device.type != "cuda" or t.numel() == 0:
            arr = t.to("cpu", copy=True).numpy()
        else:
            out = torch.empty(t.shape, dtype=t.dtype)
            self._copy(out, t.contiguous())
            arr = out.numpy()
        return arr.view(np.uint16) if bf16 else arr

    def to_device(self, arr: np.ndarray, dtype: str, device) -> torch.Tensor:
        """A fresh tensor on ``device`` (its own allocation, aligned as any
        other the allocator makes) holding ``arr``; bfloat16 from its 16
        bits."""
        arr = np.asarray(arr)
        if not arr.flags.c_contiguous:   # (np.ascontiguousarray would make a 0-d array 1-d)
            arr = arr.copy()
        if dtype == "bfloat16":
            arr = arr.view(np.uint16).view(np.int16)
        src = torch.from_numpy(arr)
        device = torch.device(device)
        if device.type != "cuda" or src.numel() == 0:
            t = src.to(device, copy=True)
        else:
            t = torch.empty(src.shape, dtype=src.dtype, device=device)
            self._copy(t, src)
        return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _host(t, stager: Stager) -> np.ndarray:
    """A copy of a tensor (or number, or array) as a host array."""
    return stager.to_host(t) if isinstance(t, torch.Tensor) else np.array(t)


def _dtype_name(t) -> str:
    if isinstance(t, torch.Tensor):
        return str(t.dtype).removeprefix("torch.")
    return str(np.asarray(t).dtype)


def _leaf_spec(leaf) -> tuple:
    """A leaf's spec in the stacked layout (() when replicated)."""
    t = leaf[0] if isinstance(leaf, Stack) else leaf
    spec = getattr(t, "spec", None) if isinstance(t, torch.Tensor) else None
    if not spec:
        return ()
    return ((None,) + tuple(spec)) if isinstance(leaf, Stack) else tuple(spec)


def _stacked_local(leaf) -> torch.Tensor:
    if isinstance(leaf, Stack):
        return torch.stack([t.detach() for t in leaf])
    return leaf.detach()


def _mesh_of(mesh):
    mesh = mesh if mesh is not None else par.ctx().mesh
    return None if mesh is None or mesh.abstract or mesh.size == 1 else mesh


def snapshot(state, mesh=None) -> tuple[dict, dict]:
    """({entry key: host array}, {key: leaf info}) of ``state`` in flatten
    order; a ``Stack`` becomes one stacked array.  An entry key is
    ``<key>::full``, or over a mesh ``<key>::<index>`` a distinct shard
    of a sharded leaf, gathered to rank 0 (the other ranks' entries are
    empty; every rank must call)."""
    mesh = _mesh_of(mesh)
    if mesh is not None:
        return _snapshot_shards(state, mesh)
    arrays, infos, stager = {}, {}, Stager()
    for path, leaf in flatten(state):
        key = SEP.join(path)
        if isinstance(leaf, Stack):
            first = _host(leaf[0], stager)
            arr = np.empty((len(leaf),) + first.shape, first.dtype)
            arr[0] = first
            for i, t in enumerate(leaf[1:], 1):
                arr[i] = _host(t, stager)
            dtype = _dtype_name(leaf[0])
        else:
            arr, dtype = _host(leaf, stager), _dtype_name(leaf)
        arrays[f"{key}::full"] = arr
        infos[key] = {"shape": list(arr.shape), "dtype": dtype, "sharded": False}
    return arrays, infos


def _snapshot_shards(state, mesh) -> tuple[dict, dict]:
    arrays, infos, stager = {}, {}, Stager()
    root = mesh.rank == 0
    positions = [mesh.coords_of(r) for r in range(mesh.size)]
    for path, leaf in flatten(state):
        key = SEP.join(path)
        spec = _leaf_spec(leaf)
        if not isinstance(leaf, (torch.Tensor, Stack)) or not shard_rules.spec_axes(spec):
            arr = _host(_stacked_local(leaf) if isinstance(leaf, Stack) else leaf, stager)
            if root:
                arrays[f"{key}::full"] = arr
            infos[key] = {"shape": list(arr.shape), "dtype": _dtype_name(
                leaf[0] if isinstance(leaf, Stack) else leaf), "sharded": False}
            continue
        local = _stacked_local(leaf)
        shape = tuple(d * shard_rules._axis_size(mesh, e) for d, e in
                      zip(local.shape, spec + (None,) * (local.dim() - len(spec))))
        every = coll.gather_raw(local[None], mesh, mesh.axis_names, 0)
        if root:
            for r, coords in enumerate(positions):
                idx = "_".join(f"{sl.start}-{sl.stop}" for sl in
                               shard_rules.local_slice(shape, spec, mesh, coords))
                arrays.setdefault(f"{key}::{idx}", None)
                if arrays[f"{key}::{idx}"] is None:
                    arrays[f"{key}::{idx}"] = _host(every[r], stager)
        del every
        infos[key] = {"shape": list(shape), "dtype": _dtype_name(local), "sharded": True}
    return arrays, infos


def _write(path: str, arrays: dict, infos: dict, step: int, extra: dict | None) -> str:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:010d}.tmp-", dir=path)
    manifest = {"step": step, "extra": extra or {}, "n_hosts": 1, "leaves": infos}
    np.savez(os.path.join(tmp, "host_00000.npz"), **arrays)
    with open(os.path.join(tmp, "manifest_00000.json"), "w") as f:
        json.dump(manifest, f)
    # fsync barrier then atomic publish
    for fn in os.listdir(tmp):
        fd = os.open(os.path.join(tmp, fn), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(path: str, state, step: int, extra: dict | None = None, *, mesh=None) -> str:
    """Write a checkpoint of ``state`` (a tree: dicts, lists, tuples,
    NamedTuples, the LM, tensors, arrays, numbers); returns its directory.
    Over a mesh every rank calls; rank 0 writes."""
    mesh = _mesh_of(mesh)
    arrays, infos = snapshot(state, mesh)
    final = os.path.join(path, f"step_{step:010d}")
    if mesh is None or mesh.rank == 0:
        final = _write(path, arrays, infos, step, extra)
    if mesh is not None:
        _barrier(mesh)
    return final


def _barrier(mesh) -> None:
    """Every rank of the mesh waits for the others (a one-element sum)."""
    coll.all_reduce_raw(torch.zeros(1, device=mesh.device or "cpu"), mesh, mesh.axis_names)


def list_steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    steps = []
    for d in os.listdir(path):
        if d.startswith("step_") and ".tmp" not in d:
            steps.append(int(d.split("_")[1]))
    return sorted(steps)


def _index_slices(idx_id: str, shape):
    if idx_id in ("full", "scalar", ""):
        return tuple(slice(None) for _ in shape)
    out = []
    for part in idx_id.split("_"):
        a, b = part.split("-")
        out.append(slice(int(a), int(b)))
    return tuple(out)


def _device_of(like):
    if isinstance(like, Stack):
        like = like[0]
    dev = like.device if isinstance(like, torch.Tensor) else torch.device("cpu")
    return torch.device("cpu") if dev.type == "meta" else dev


def _overlap(dst: tuple, src: tuple):
    """(dst-relative, src-relative) slices of two boxes' intersection, or
    None when they do not meet."""
    a, b = [], []
    for d, s in zip(dst, src):
        lo, hi = max(d.start, s.start), min(d.stop, s.stop)
        if lo >= hi:
            return None
        a.append(slice(lo - d.start, hi - d.start))
        b.append(slice(lo - s.start, hi - s.start))
    return tuple(a), tuple(b)


def restore(path: str, state_like, step: int | None = None, shardings=None, mesh=None):
    """Rebuild ``state_like``'s tree from the checkpoint of ``step`` (the
    latest by default).  Returns (state, manifest).  Each leaf takes the
    manifest's dtype and the device of the leaf it replaces (the CPU for
    a meta tensor, an array or a number); a ``Stack`` is cut back into its
    groups.  A module in ``state_like`` (the LM) is filled in place, its
    parameters given the restored tensors, and returned as it is.

    Over a mesh (``mesh=``, or the context's) each leaf is this rank's
    shard under its spec in ``shardings`` (a tree like ``state_like``'s
    of specs in the stacked layout; by default each leaf's own ``spec``),
    whatever mesh wrote the checkpoint, and carries that spec."""
    steps = list_steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    step = step if step is not None else steps[-1]
    d = os.path.join(path, f"step_{step:010d}")

    manifests = sorted(f for f in os.listdir(d) if f.startswith("manifest"))
    with open(os.path.join(d, manifests[0])) as f:
        manifest = json.load(f)

    mesh = _mesh_of(mesh)
    flat = flatten(state_like)
    flat_like = {SEP.join(p): leaf for p, leaf in flat}
    specs = ([spec for _, spec in flatten_specs(shardings, flat)] if shardings is not None
             else [_leaf_spec(leaf) for _, leaf in flat])
    spec_of = dict(zip(flat_like, specs))
    # This rank's box of each leaf (the whole leaf off a mesh).
    boxes = {}
    for key in flat_like:
        info = manifest["leaves"].get(key)
        if info is None:
            continue
        shape = tuple(info["shape"])
        boxes[key] = (shard_rules.local_slice(shape, spec_of[key], mesh)
                      if mesh is not None and spec_of[key]
                      else tuple(slice(0, n) for n in shape))
    buffers: dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".npz"):
            continue
        with np.load(os.path.join(d, fn)) as z:
            for full_key in z.files:
                key, idx_id = full_key.split("::")
                if key not in boxes:
                    continue
                shape = tuple(manifest["leaves"][key]["shape"])
                box = boxes[key]
                src = tuple(slice(0 if s.start is None else s.start,
                                  n if s.stop is None else s.stop)
                            for s, n in zip(_index_slices(idx_id, shape), shape))
                if src == box:
                    buffers[key] = z[full_key]
                    continue
                ov = _overlap(box, src)
                if ov is None:
                    continue
                data = z[full_key]
                if key not in buffers:
                    buffers[key] = np.zeros(tuple(s.stop - s.start for s in box),
                                            dtype=data.dtype)
                buffers[key][ov[0]] = data[ov[1]]

    out, stager = [], Stager()
    for key, like in flat_like.items():
        if key not in buffers:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr, dtype = buffers.pop(key), manifest["leaves"][key]["dtype"]
        spec = spec_of[key] if mesh is not None else ()
        shape = tuple(like.shape) if hasattr(like, "shape") else np.shape(like)
        if mesh is None and tuple(arr.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != {shape}")
        if isinstance(like, Stack):   # each group its own tensor
            out.append(Stack(_spec_on(stager.to_device(a, dtype, _device_of(like)), spec[1:])
                             for a in arr))
        else:
            out.append(_spec_on(stager.to_device(arr, dtype, _device_of(like)), spec))
    return _rebuild(state_like, iter(out)), manifest


def flatten_specs(shardings, flat_like):
    """[(path, spec)] of a tree of specs laid out as ``flat_like``'s tree
    (a spec, a tuple of entries, is one leaf)."""
    out = []

    def at(node, path):
        for key in path:
            node = node[key] if isinstance(node, dict) else (
                getattr(node, key) if hasattr(node, "_fields") else node[int(key)])
        return node

    for path, _ in flat_like:
        out.append((path, tuple(at(shardings, path))))
    return out


def _spec_on(t: torch.Tensor, spec) -> torch.Tensor:
    if spec and any(e is not None for e in spec):
        t.spec = tuple(spec)
    return t


def _rebuild(node, it):
    """``node``'s structure holding the restored leaves ``it`` yields in
    flatten order; a module (an object with ``tree()``) gets its leaves as
    its parameters' data and is returned itself."""
    if node is None:
        return None
    if hasattr(node, "tree") and callable(node.tree):
        for _, leaf in flatten(node.tree()):
            new = next(it)
            for p, t in zip(leaf if isinstance(leaf, Stack) else (leaf,),
                            new if isinstance(new, Stack) else (new,)):
                p.data = t.contiguous()
                if getattr(t, "spec", None):
                    p.spec = t.spec
        return node
    if isinstance(node, Stack) or not isinstance(node, (dict, list, tuple)):
        return next(it)
    if isinstance(node, dict):
        built = {key: _rebuild(node[key], it) for key in sorted(node)}
        return {key: built[key] for key in node}
    if hasattr(node, "_fields"):
        return type(node)(*(_rebuild(getattr(node, n), it) for n in node._fields))
    return type(node)(_rebuild(sub, it) for sub in node)


@dataclasses.dataclass
class CheckpointManager:
    path: str
    keep: int = 3
    _thread: threading.Thread | None = None

    def save_async(self, state, step: int, extra: dict | None = None):
        """Snapshot to host memory synchronously, write in the background
        (over a mesh every rank snapshots, rank 0 writes)."""
        mesh = _mesh_of(None)
        arrays, infos = snapshot(state, mesh)
        self.wait()
        if mesh is not None and mesh.rank != 0:
            return
        self._thread = threading.Thread(
            target=self._save_and_gc, args=(arrays, infos, step, extra), daemon=True)
        self._thread.start()

    def save(self, state, step: int, extra: dict | None = None):
        self.wait()
        mesh = _mesh_of(None)
        arrays, infos = snapshot(state, mesh)
        if mesh is None or mesh.rank == 0:
            self._save_and_gc(arrays, infos, step, extra)
        if mesh is not None:
            _barrier(mesh)

    def _save_and_gc(self, arrays, infos, step, extra):
        _write(self.path, arrays, infos, step, extra)
        steps = list_steps(self.path)
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:010d}"), ignore_errors=True)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def latest_step(self) -> int | None:
        steps = list_steps(self.path)
        return steps[-1] if steps else None
