"""The dry run's count of one rank's step: the port's counterpart of the
reference package's ``launch/hlo_cost.py`` (and of
``roofline.collective_bytes``).

The reference compiles the step and reads the partitioned HLO.  The port
runs eagerly and has no HLO, so it traces the step itself, on fake tensors
(torch's ``meta`` device: shapes, dtypes and strides, no data; a
``FakeTensorMode`` over the CPU gives the same counts at twice the time a
cell) in a fake world (``launch.mesh.fake_world``), under a
``TorchDispatchMode`` that sees every aten op the rank would run:

* **FLOPs**: the matmul family, by ``torch.utils.flop_counter``'s
  formulas (``hlo_cost`` also counts only ``dot``), but for a product
  whose contraction has length 1 (an outer product: the plain SSD's and
  a one-row attention's VJP make them), which XLA's simplifier rewrites
  into an elementwise multiply that ``hlo_cost`` does not count;
  B7/B8/B9 on fake tensors add their plain route's FLOPs in closed form
  (``kernels/ops.py``).
* **Bytes**: each aten op that is not a view reads its tensor inputs and
  writes its outputs, every distinct element once (a stride-0 axis read
  once); allocating an uninitialised tensor, or an op with no tensor out
  (``prim.device``), moves nothing.  The port runs
  eager, with no fusion, so every intermediate goes through memory; a
  kernel's intermediates do not (B7/B8/B9 add their inputs and outputs).
* **Peak**: each storage counted once from the op that made it to its
  last reference, rounded up to 512 bytes as the card's caching allocator
  rounds a block (``torch.distributed._tools.mem_tracker.MemTracker``
  keeps the same ledger and works on fake tensors; the count keeps its
  own because a traced VJP's transient must be replayed, below).  A meta
  storage has a size and no data, so the ledger is the card's.
* **Collectives**: by kind, from ``parallel.collectives.STATS`` (calls and
  the bytes a rank puts in).

``Count.vjp`` traces the plain-version VJP of a kernel's backward once a
signature (shapes, strides, dtypes, options) and replays its FLOPs, bytes
and transient peak at later calls: every layer of a model gives B7 the
same shapes, and the chunked attention's VJP is thousands of ops.

**Trip weighting** (``weigh``), the counterpart of ``hlo_cost._weights``:
the block groups run one code on one set of shapes each, and so do the
microbatches, so every count is affine in the number of groups and of
microbatches.  The dry run traces two depths (and two microbatch counts),
and ``weigh`` extends each count along those lines to the full ones.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import ops
from repro_torch.parallel import collectives as coll

BLOCK = 512   # the caching allocator's rounding of a block, bytes

_aten = torch.ops.aten
# The matmul family: the position of the left operand, whose last
# dimension is the contraction.
_PRODUCTS = {_aten.mm: 0, _aten.bmm: 0, _aten.addmm: 1, _aten.baddbmm: 1}
# Ops that allocate without writing: no traffic.
_NO_TRAFFIC = {_aten.empty, _aten.empty_strided, _aten.empty_like, _aten.new_empty,
               _aten.new_empty_strided}


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _meta(t):
    if not isinstance(t, torch.Tensor):
        return None
    return (tuple(t.shape), tuple(t.stride()), t.dtype, t.device.type)


def _outer_product(packet, args) -> bool:
    """A product of the matmul family whose contraction has length 1."""
    i = _PRODUCTS.get(packet)
    return i is not None and args[i].shape[-1] == 1


class _Mode(TorchDispatchMode):
    def __init__(self, count: "Count"):
        super().__init__()
        self.count = count

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.count._op(func, args, kwargs, out)
        return out


class Count:
    """The count of what the ops run under it cost this rank.  Storages
    are tracked from entry (set-up included: the parameters, the optimizer
    state and the inputs become ``resident``); FLOPs, bytes, ops and
    collectives are counted inside ``measure()`` only.  ``card``: meta
    tensors take the card's routes (B7/B8/B9 where the card launches them;
    ``kernels/ops.py``), else the plain versions'.  ``memo`` (a dict) may
    be shared between counts to replay a VJP traced in another."""

    def __init__(self, card: bool = True, memo: dict | None = None):
        self.card = card
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.kernels: dict = {}
        self.live = 0
        self.peak = 0
        self.resident = 0
        self.collectives = {k: {"calls": 0, "bytes": 0} for k in coll.KINDS}
        self.memo = {} if memo is None else memo
        self.counting = False
        self._storages = WeakIdKeyDictionary()
        self._mode = None

    # -- entry -------------------------------------------------------------

    def __enter__(self):
        if ops.COUNT is not None:
            raise RuntimeError("a count is already active")
        self._mode = _Mode(self)
        self._mode.__enter__()
        ops.COUNT = self
        return self

    def __exit__(self, *exc):
        ops.COUNT = None
        self._mode.__exit__(*exc)
        return False

    @contextlib.contextmanager
    def measure(self):
        """Count the ops run inside (the step); what is live on entry is
        ``resident``, and the peak is taken from there."""
        start = {k: dict(v) for k, v in coll.STATS["kinds"].items()}
        self.resident = self.peak = self.live
        self.counting = True
        try:
            yield self
        finally:
            self.counting = False
            for k, v in coll.STATS["kinds"].items():
                self.collectives[k] = {f: v[f] - start[k][f] for f in v}

    # -- what ops and kernels add -------------------------------------------

    def _alloc(self, nbytes: int) -> None:
        self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (NotImplementedError, RuntimeError):
            return
        if st in self._storages:
            return
        n = -(-st.nbytes() // BLOCK) * BLOCK
        self._storages[st] = weakref.finalize(st, self._free, n)
        self._alloc(n)

    def _op(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        for t in outs:
            self._track(t)
        if not self.counting:
            return
        self.ops += 1
        packet = func._overloadpacket
        flops = flop_registry.get(packet)
        if flops is not None and not _outer_product(packet, args):
            self.flops += int(flops(*args, **kwargs, out_val=out))
        if not outs or func.is_view or packet in _NO_TRAFFIC:
            return   # metadata (no tensor out), an alias, or an allocation
        ins = _tensors((args, {k: v for k, v in kwargs.items() if k != "out"}))
        self.bytes += sum(map(ops.distinct_bytes, ins + outs))

    def kernel(self, name: str, flops: int, nbytes: int) -> None:
        """A kernel's call on meta tensors (``kernels/ops.py``)."""
        if not self.counting:
            return
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def vjp(self, key, inputs, needs, cotangent, run):
        """The gradients ``run()`` gives (a kernel backward's plain VJP),
        traced the first time this signature is seen and replayed after:
        its FLOPs, bytes and ops added, its transient peak above the live
        bytes reached, its gradients allocated empty."""
        sig = (key, tuple(map(_meta, inputs)), tuple(needs), _meta(cotangent))
        hit = self.memo.get(sig)
        if hit is None:
            before = (self.flops, self.bytes, self.ops, self.live)
            outer = self.peak
            self.peak = self.live
            grads = run()
            self.memo[sig] = {"flops": self.flops - before[0], "bytes": self.bytes - before[1],
                              "ops": self.ops - before[2], "transient": self.peak - before[3],
                              "grads": [_meta(g) for g in grads]}
            self.peak = max(outer, self.peak)
            return grads
        self.flops += hit["flops"]
        self.bytes += hit["bytes"]
        self.ops += hit["ops"]
        self.peak = max(self.peak, self.live + hit["transient"])
        dev = cotangent.device
        counting, self.counting = self.counting, False   # stand-ins: no ops of the step
        try:
            return [None if m is None else torch.empty_strided(m[0], m[1], dtype=m[2],
                                                               device=dev)
                    for m in hit["grads"]]
        finally:
            self.counting = counting

    def summary(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "collectives": {k: dict(v) for k, v in self.collectives.items()},
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "resident_bytes": self.resident, "peak_bytes": self.peak}


def affine(a, b, at: int, n: int):
    """Every number of the summaries ``a`` (traced at depth ``at``) and
    ``b`` (at ``at + 1``) extended along their line to depth ``n``."""
    if isinstance(a, dict):
        return {k: affine(a[k], b[k], at, n) for k in a}
    return a + (b - a) * (n - at)


def depths(n: int) -> tuple:
    """The depths to trace for a full depth ``n``: ``n`` itself up to 3,
    else 2 and 3 (a depth of 1 can take another code path: a one-group
    stacked leaf is a view, not a stack)."""
    return (n,) if n <= 3 else (2, 3)


def weigh(traced: dict, groups: int, micro: int) -> dict:
    """The count at ``groups`` block groups and ``micro`` microbatches from
    ``traced``, {(groups, microbatches): summary} at one or two
    consecutive values of each (``depths``; one: that value is the full
    one)."""
    gs = sorted({g for g, _ in traced})
    ms = sorted({m for _, m in traced})

    def at_groups(g):
        if len(ms) == 1:
            return traced[(g, ms[0])]
        return affine(traced[(g, ms[0])], traced[(g, ms[1])], ms[0], micro)

    if len(gs) == 1:
        return at_groups(gs[0])
    return affine(at_groups(gs[0]), at_groups(gs[1]), gs[0], groups)
