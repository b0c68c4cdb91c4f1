"""Roofline terms of one traced step, at the H100 SXM's constants.

Three terms per (arch x shape x mesh), per device:

  compute    = FLOPs / PEAK_FLOPS       (bf16 dense tensor-core peak)
  memory     = bytes / HBM_BW
  collective = collective bytes / LINK_BW (NVLink, one direction)

The reference reads FLOPs and bytes from XLA's ``cost_analysis()`` and
parses collectives out of the compiled HLO. The port counts them while
the step runs once on fake tensors (``launch/dryrun.py``): ``CostMode``
is a dispatch mode that lets DTensor run first (it declines every op on a
DTensor), so what it sees are the LOCAL ops each rank runs on its shards,
and the c10d functional collectives DTensor and the model code issue.

* FLOPs: ``torch.utils.flop_counter``'s formulas over the local shapes
  (matrix products, attention; elementwise ops count none, as there).
  DTensor also runs each new op once on fake tensors of the global
  shapes to learn its output's shape; those runs are not counted.
* bytes: every op that is not a view reads each input once and writes its
  output once. Nothing is fused, so this is an upper bound on what an
  eager step moves (XLA's count is of fused kernels).
* the hand-written kernels (the decode attention): one opaque call each,
  as XLA counts a custom call: operands plus outputs, FLOPs from the
  shapes (``CostMode.opaque_call``, which ``kernels.ops`` calls on
  ``meta`` tensors under this mode); what they do inside is not traced.
* collective bytes: per kind, max(input, output) bytes of each functional
  collective, each counted once at its issue (``wait_tensor`` is not a
  transfer), as the reference counts an async start and not its done.
  The other ops of the collectives' namespaces (``wait_tensor``, the
  autograd wrapper ``_wrap_tensor_autograd``) move no local bytes.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass

# NVIDIA H100 SXM5 80 GB, per card (the hopper-kernels guide's table).
PEAK_FLOPS = 989e12          # bf16 FLOP/s, dense tensor cores
HBM_BW = 3.35e12             # bytes/s
LINK_BW = 450e9              # NVLink 4, bytes/s each way

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# c10d functional op -> the reference's HLO collective kind
FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # DTensor's Shard(a) -> Shard(b)
    "broadcast": "collective-permute",
}


def collective_bytes(trace):
    """Per-device bytes moved by the collectives of ``trace`` and their
    breakdown. ``trace``: records (op name, input bytes, output bytes) in
    issue order; an op is a functional collective's name (``all_reduce``,
    ``_c10d_functional.all_reduce``, ...) or ``wait_tensor``, which
    completes an earlier one and moves nothing. Returns (total, {kind:
    bytes}, count)."""
    per_kind = {k: 0 for k in KINDS}
    count = 0
    for op, in_b, out_b in trace:
        name = op.rsplit(".", 1)[-1]
        if name not in FUNCOL_KIND:
            continue
        per_kind[FUNCOL_KIND[name]] += max(int(in_b), int(out_b))
        count += 1
    return sum(per_kind.values()), per_kind, count


@dataclass
class Roofline:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: dict
    n_collectives: int

    @property
    def t_compute(self):
        return self.flops_per_dev / PEAK_FLOPS

    @property
    def t_memory(self):
        return self.bytes_per_dev / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes_per_dev / LINK_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_max(self):
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self):
        return {
            "flops_per_dev": self.flops_per_dev,
            "bytes_per_dev": self.bytes_per_dev,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "coll_breakdown": self.coll_breakdown,
            "n_collectives": self.n_collectives,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
        }


def _nbytes(t):
    import torch
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _in_shape_propagation() -> bool:
    """True inside DTensor's output-shape propagation, which runs an op
    once on fake tensors of the GLOBAL shapes (no rank runs it): its ops
    are not counted. Found by the propagating frame on the stack."""
    import sys
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


def cost_mode():
    """A fresh ``CostMode`` (a ``TorchDispatchMode``; built here so that
    importing this module needs no dispatch machinery)."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    meta_ops = {torch.ops.aten.detach.default, torch.ops.aten.alias.default,
                torch.ops.prim.device.default}

    class CostMode(TorchDispatchMode):
        """Counts the local FLOPs, bytes, collectives and live storage of
        what runs inside it (see the module docstring)."""

        def __init__(self):
            super().__init__()
            self.flops = 0
            self.bytes = 0
            self.trace = []
            self.live = 0
            self.peak = 0
            self._seen = set()
            self.opaque = {}

        def _track(self, out):
            for t in _tensors(out):
                st = t.untyped_storage()
                key = id(st)
                if key in self._seen:
                    continue
                n = st.nbytes()
                self._seen.add(key)
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key, n)

        def _free(self, key, n):
            self._seen.discard(key)
            self.live -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented     # DTensor runs its local ops here
            out = func(*args, **kwargs)
            if (func in meta_ops or not isinstance(func, torch._ops.OpOverload)
                    or _in_shape_propagation()):
                return out
            ns = func.namespace
            name = func._overloadpacket.__name__
            if ns in ("_c10d_functional", "_dtensor"):
                # a collective, or its wait or autograd wrapper
                # (``_wrap_tensor_autograd``): no local bytes
                if name in FUNCOL_KIND or name == "wait_tensor":
                    self.trace.append((f"{ns}.{name}", _nbytes(args[0]),
                                       _nbytes(out)))
                return out
            if func.is_view:
                return out
            pk = func._overloadpacket
            if pk in flop_registry:
                self.flops += flop_registry[pk](*args, **kwargs, out_val=out)
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += _nbytes(out) if not isinstance(out, (list, tuple)) \
                else sum(_nbytes(t) for t in _tensors(out))
            self._track(out)
            return out

        def opaque_call(self, name, inputs, out, flops):
            """A kernel the trace cannot see into (``kernels.ops`` on
            ``meta`` tensors), counted as XLA counts a custom call: its
            operands read once, its outputs written once, ``flops``."""
            self.flops += flops
            self.bytes += sum(_nbytes(t) for t in _tensors(inputs))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
            self.opaque[name] = self.opaque.get(name, 0) + 1
            self._track(out)

        def roofline(self):
            cb, breakdown, n = collective_bytes(self.trace)
            return Roofline(float(self.flops), float(self.bytes), float(cb),
                            breakdown, n)

    return CostMode()


def model_flops(cfg, shape):
    """Analytic MODEL_FLOPS: 6*N*D train, 2*N*D per generated/processed
    token at inference (N = active params)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch   # decode: 1 token/request
