"""Typed failure taxonomy + deterministic, seeded fault injection.

The serving stack distinguishes two failure classes:

* ``RequestError``: a failure attributable to ONE request. The engine
  quarantines that request (abort + refcount-exact page release + a typed
  ``StepOutput`` with ``finish_reason="error"``) and the rest of the batch
  keeps decoding. Subclasses keep backwards-compatible bases:
  ``CapacityError`` is-a ``MemoryError`` (the page-budget signal) and
  ``ValidationError`` is-a ``ValueError`` (the ``add_request``
  rejections), so callers catching the old types keep working while new
  callers can catch the taxonomy root.
* ``EngineFault``: the engine itself is wrong (an invariant audit found
  pool / block-table / phase corruption, or the degraded decode failed
  too). Not recoverable per request.

``FaultInjector`` is a deterministic, seeded injector threaded through the
engine's named sites (``SITES``). A fault *plan* is a list of
``FaultSpec``s; whether a spec fires at a given call depends only on
``(seed, spec index, site, step, uid)`` (a blake2b hash, never wall clock,
call order across sites or process state), so a plan replays byte for
byte against the same workload, and fires identically in the JAX package
and here. Every firing is recorded in ``fired`` (site, step, uid, mode,
arm), which doubles as the soak report's "affected requests" ledger.

Injection sites (where the engine consults the injector):

========================  ==================================================
``pool.alloc``            admission planning (``_plan_admission``): mode
                          ``transient`` blocks the plan this step (retried);
                          mode ``error`` quarantines the queued request.
``snapshot.restore``      CHAI-snapshot admission: the restore fails; the
                          engine drops the snapshot and re-plans the request
                          cold (greedy tokens are unchanged by design).
``relay.residency``       relay group formation: the groups formed this
                          step dissolve to the per-request decode path.
``kernel.decode``         the decode dispatch, raised before any launch:
                          the engine retries the step on the plain
                          versions of its decode kernels (``kernels.ref``)
                          and stays there (``degraded_decode``) until it
                          heals (``EngineConfig.decode_heal_steps``).
``kernel.prefill``        slot prefill at admission (``_admit_to_slot``,
                          after the slot enters PREFILL): the request is
                          quarantined; the slot tears down refcount-exactly.
``kernel.cluster``        the WARMUP->CLUSTER transition
                          (``_cluster_transitions``): the transitioning
                          request is quarantined before clustering mutates
                          the pools; others keep decoding.
``step.logits``           per-slot logits poisoning (NaN): the NaN/Inf
                          guard quarantines the slot, others are untouched.
``offload.out``           KV-tier demotion (``_demote_entry``): mode
                          ``corrupt`` damages the host copy after its CRC
                          stamp (promotion catches it, drops the entry and
                          re-plans the request cold); any other mode
                          declines the demotion (the victim drops).
``offload.in``            KV-tier promotion (``_promote_entry``): the entry
                          drops and the request re-plans cold; at a
                          preemption swap-in the victim is quarantined, as
                          at ``swap.in``.
``swap.corrupt``          preemption swap-out (``_swap_out_slot``): damages
                          the host copy of the victim's slot after its CRC
                          stamp; the swap-in catches the mismatch and
                          quarantines the victim before any device write.
``swap.in``               preemption swap-in (``_swap_in_slot``): fails the
                          resume; the victim is quarantined, its host
                          pages released.
========================  ==================================================

``checksum_arrays`` and ``corrupt_arrays`` take numpy arrays and torch
tensors (on any device) alike. A bf16 tensor is hashed as the JAX package
hashes an ``ml_dtypes`` bf16 array: under the dtype name ``"bfloat16"``
and its raw 16-bit patterns. This module imports numpy, hashlib and zlib
only; a tensor's own package is looked up where the tensor came from.
"""
from __future__ import annotations

import dataclasses
import hashlib
import sys
import zlib
from typing import List, Optional

import numpy as np

# -- taxonomy ---------------------------------------------------------------


class RequestError(Exception):
    """Request-isolatable failure: quarantine ONE request, keep the batch
    running. ``uid`` names the request when known."""

    def __init__(self, msg: str, *, uid: Optional[int] = None):
        super().__init__(msg)
        self.uid = uid


class ValidationError(RequestError, ValueError):
    """The request itself is malformed (rejected at ``add_request``)."""


class CapacityError(RequestError, MemoryError):
    """The request can NEVER be admitted: its page needs exceed pool
    capacity even with the prefix cache drained (the page-budget
    ``MemoryError``, now carrying the uid)."""


class QuarantineError(RequestError):
    """Mid-flight state damage attributable to one request (injected
    fault, non-finite logits): the request is typed-failed; its pages
    return refcount-exactly."""


class SnapshotRestoreError(RequestError):
    """A CHAI-snapshot restore failed. Recoverable: the engine drops the
    snapshot and re-plans the admission cold."""


class EngineFault(RuntimeError):
    """The engine state itself is corrupt (invariant breach) or the
    last-resort decode path failed."""

    def __init__(self, msg: str, violations=()):
        self.violations = list(violations)
        if self.violations:
            msg = msg + "\n  - " + "\n  - ".join(self.violations)
        super().__init__(msg)


class InjectedFault(Exception):
    """Raised by injector arms standing in for a runtime failure (a kernel
    launch error, raised before any launch); never escapes the engine: the
    handler at the site converts it into recovery or a typed error."""

    def __init__(self, site: str, msg: str = ""):
        super().__init__(msg or f"injected fault at {site}")
        self.site = site


# -- injector ---------------------------------------------------------------

SITES = frozenset({
    "pool.alloc", "swap.corrupt", "swap.in", "snapshot.restore",
    "relay.residency", "kernel.decode", "kernel.prefill", "kernel.cluster",
    "step.logits", "offload.out", "offload.in",
})

#: spec modes with meaning at their sites (see module docstring)
MODES = frozenset({"error", "transient", "corrupt", "nan"})


@dataclasses.dataclass
class FaultSpec:
    """One arm of a fault plan.

    site   one of ``SITES``.
    mode   what the site does when the arm fires (site-specific).
    step   fire only at this engine step (-1 = any step).
    uid    fire only for this request uid (-1 = any request).
    count  firings before the arm is spent (-1 = unlimited).
    p      per-eligible-call firing probability; decided by a stable hash
           of (seed, arm index, site, step, uid), NOT a stateful RNG, so
           replays are byte-for-byte identical.
    """
    site: str
    mode: str = "error"
    step: int = -1
    uid: int = -1
    count: int = 1
    p: float = 1.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {sorted(SITES)}")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; "
                             f"modes: {sorted(MODES)}")
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"p must be in (0, 1], got {self.p}")


class FaultInjector:
    """Deterministic seeded injector over a list of ``FaultSpec``s.

    ``fire(site, step=, uid=)`` returns the first eligible spec (or None)
    and logs the firing. Eligibility is pure in (spec, site, step, uid)
    plus the spec's remaining count; the probabilistic roll hashes
    ``(seed, arm, site, step, uid)`` so two runs over the same workload
    fire identically.
    """

    def __init__(self, specs: List[FaultSpec], *, seed: int = 0):
        self.specs = list(specs)
        self.seed = int(seed)
        self._remaining = [s.count for s in self.specs]
        self.fired: List[dict] = []

    def _roll(self, idx: int, spec: FaultSpec, step: int, uid: int) -> bool:
        if spec.p >= 1.0:
            return True
        key = f"{self.seed}:{idx}:{spec.site}:{step}:{uid}".encode()
        h = int.from_bytes(hashlib.blake2b(key, digest_size=8).digest(),
                           "big")
        return (h / float(1 << 64)) < spec.p

    def fire(self, site: str, *, step: int = -1,
             uid: int = -1) -> Optional[FaultSpec]:
        for idx, spec in enumerate(self.specs):
            if spec.site != site:
                continue
            if spec.step != -1 and spec.step != step:
                continue
            if spec.uid != -1 and spec.uid != uid:
                continue
            if self._remaining[idx] == 0:
                continue
            if not self._roll(idx, spec, step, uid):
                continue
            if self._remaining[idx] > 0:
                self._remaining[idx] -= 1
            self.fired.append({"site": site, "step": int(step),
                               "uid": int(uid), "mode": spec.mode,
                               "arm": idx})
            return spec
        return None

    def report(self) -> dict:
        """JSON-ready plan + firing log (the soak report embeds it)."""
        return {"seed": self.seed,
                "specs": [dataclasses.asdict(s) for s in self.specs],
                "fired": list(self.fired)}


# -- host-payload integrity helpers ----------------------------------------

def _is_tensor(x) -> bool:
    return type(x).__module__.split(".")[0] == "torch" and hasattr(x, "cpu")


def _host_array(x) -> np.ndarray:
    """A C-contiguous host numpy copy of an array or a tensor (a bf16
    tensor: its 16-bit patterns as int16)."""
    if not _is_tensor(x):
        return np.ascontiguousarray(np.asarray(x))
    t = x.detach().cpu().contiguous()
    if _dtype_name(x) == "bfloat16":
        t = t.view(sys.modules["torch"].int16)
    return t.numpy()


def _dtype_name(x) -> str:
    if _is_tensor(x):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


def checksum_arrays(tree) -> int:
    """Order-stable CRC32 over a (possibly nested) dict of arrays or
    tensors: the dtype name, the shape and the raw bytes of each leaf,
    keys in sorted order (equal to the JAX package's for equal payloads)."""
    crc = 0
    if isinstance(tree, dict):
        for k in sorted(tree):
            crc = zlib.crc32(str(k).encode(), crc)
            crc = zlib.crc32(checksum_arrays(tree[k]).to_bytes(4, "big"),
                             crc)
        return crc
    arr = _host_array(tree)
    crc = zlib.crc32(_dtype_name(tree).encode() + str(arr.shape).encode(),
                     crc)
    return zlib.crc32(arr.tobytes(), crc)


def corrupt_arrays(tree: dict, *, seed: int = 0) -> bool:
    """Deterministically flip bits in the first non-empty leaf of a nested
    dict (in sorted-key order). The damaged leaf is REPLACED with a
    flipped copy of its own kind (a tensor stays a tensor of its dtype on
    its device). Returns True if anything was corrupted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            if corrupt_arrays(v, seed=seed):
                return True
            continue
        buf = np.array(_host_array(v), copy=True)
        if buf.size == 0:
            continue
        flat = buf.view(np.uint8).reshape(-1)
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, flat.size, size=min(8, flat.size))
        flat[idx] ^= 0xFF
        if _is_tensor(v):
            t = sys.modules["torch"].from_numpy(buf)
            if _dtype_name(v) == "bfloat16":
                t = t.view(v.dtype)
            buf = t.to(v.device)
        tree[k] = buf
        return True
    return False
