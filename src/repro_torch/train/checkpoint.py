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

The reference's multi-host shards and elastic re-sharding need several
cards (ROADMAP A10 item 6); one process owns every leaf here.
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

from repro_torch.models.tree import Stack, flatten

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


def snapshot(state) -> tuple[dict, dict]:
    """({key: host array}, {key: leaf info}) of ``state`` in flatten order;
    a ``Stack`` becomes one stacked array."""
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
        arrays[key] = arr
        infos[key] = {"shape": list(arr.shape), "dtype": dtype, "sharded": False}
    return arrays, infos


def _write(path: str, arrays: dict, infos: dict, step: int, extra: dict | None) -> str:
    os.makedirs(path, exist_ok=True)
    final = os.path.join(path, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(prefix=f"step_{step:010d}.tmp-", dir=path)
    manifest = {"step": step, "extra": extra or {}, "n_hosts": 1, "leaves": infos}
    np.savez(os.path.join(tmp, "host_00000.npz"),
             **{f"{key}::full": arr for key, arr in arrays.items()})
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


def save(path: str, state, step: int, extra: dict | None = None) -> str:
    """Write a checkpoint of ``state`` (a tree: dicts, lists, tuples,
    NamedTuples, the LM, tensors, arrays, numbers); returns its directory."""
    arrays, infos = snapshot(state)
    return _write(path, arrays, infos, step, extra)


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


def restore(path: str, state_like, step: int | None = None):
    """Rebuild ``state_like``'s tree from the checkpoint of ``step`` (the
    latest by default).  Returns (state, manifest).  Each leaf takes the
    manifest's dtype and the device of the leaf it replaces (the CPU for
    a meta tensor, an array or a number); a ``Stack`` is cut back into its
    groups.  A module in ``state_like`` (the LM) is filled in place, its
    parameters given the restored tensors, and returned as it is."""
    steps = list_steps(path)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {path}")
    step = step if step is not None else steps[-1]
    d = os.path.join(path, f"step_{step:010d}")

    manifests = sorted(f for f in os.listdir(d) if f.startswith("manifest"))
    with open(os.path.join(d, manifests[0])) as f:
        manifest = json.load(f)

    flat_like = {SEP.join(p): leaf for p, leaf in flatten(state_like)}
    buffers: dict[str, np.ndarray] = {}
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".npz"):
            continue
        with np.load(os.path.join(d, fn)) as z:
            for full_key in z.files:
                key, idx_id = full_key.split("::")
                if key not in flat_like:
                    continue
                info = manifest["leaves"][key]
                data = z[full_key]
                if idx_id == "full":
                    buffers[key] = data
                    continue
                if key not in buffers:
                    buffers[key] = np.zeros(info["shape"], dtype=data.dtype)
                buffers[key][_index_slices(idx_id, info["shape"])] = data

    out, stager = [], Stager()
    for key, like in flat_like.items():
        if key not in buffers:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr, dtype = buffers.pop(key), manifest["leaves"][key]["dtype"]
        shape = tuple(like.shape) if hasattr(like, "shape") else np.shape(like)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != {shape}")
        if isinstance(like, Stack):   # each group its own tensor
            out.append(Stack(stager.to_device(a, dtype, _device_of(like)) for a in arr))
        else:
            out.append(stager.to_device(arr, dtype, _device_of(like)))
    return _rebuild(state_like, iter(out)), manifest


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
        """Snapshot to host memory synchronously, write in the background."""
        arrays, infos = snapshot(state)
        self.wait()
        self._thread = threading.Thread(
            target=self._save_and_gc, args=(arrays, infos, step, extra), daemon=True)
        self._thread.start()

    def save(self, state, step: int, extra: dict | None = None):
        self.wait()
        self._save_and_gc(*snapshot(state), step, extra)

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
