"""Per-request sampling configuration + host-side finish conditions.

``SamplingParams`` is the knob set a request carries through the engine,
field for field the reference's. Greedy decode (``temperature == 0``) is
``argmax`` over the fp32 logits; ``temperature > 0`` draws through the
batched seeded top-k / top-p sampler (``launch.steps.make_sampler``).
Stop strings are matched against the engine's detokenizer, and
``scan_finish`` truncates a token list at its first finish condition.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

FINISH_LENGTH = "length"      # max_new_tokens reached
FINISH_STOP = "stop"          # stop token id or stop string matched
FINISH_ABORT = "aborted"      # abort() mid-flight (queued or running)
FINISH_ERROR = "error"        # quarantined by a typed RequestError
#                               (Request.error carries the message)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode parameters.

    temperature  0 = greedy (bitwise-identical to argmax); > 0 scales
                 logits before the categorical draw.
    top_k        keep only the k highest logits (0 = full vocabulary).
    top_p        nucleus sampling: keep the smallest prefix of the
                 descending-probability vocab whose mass reaches top_p
                 (1.0 = off). Applied after top_k.
    seed         per-request sampler seed (uint32): token n of the request
                 draws from (seed, n) only.
    stop_token_ids  finish ("stop") when the last sampled token is one
                 of these; the stop token is kept in the output.
    stop         stop strings, matched against the engine detokenizer's
                 rendering of the generated tokens (requires the engine
                 to be built with a detokenizer).
    max_new_tokens  generation budget; finish reason "length".
    """
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop_token_ids: Tuple[int, ...] = ()
    stop: Tuple[str, ...] = ()
    max_new_tokens: int = 32

    def __post_init__(self):
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))
        object.__setattr__(self, "stop", tuple(self.stop))
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), "
                             f"got {self.top_k}")
        if not 0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0


def knob_vectors(n: int) -> dict:
    """The sampler's per-row knobs (host arrays) for ``n`` greedy rows."""
    return {"temperature": np.zeros((n,), np.float32),
            "top_k": np.zeros((n,), np.int32),
            "top_p": np.ones((n,), np.float32),
            "seed": np.zeros((n,), np.uint32)}


def set_knobs(knobs: dict, row: int, params: SamplingParams):
    """Row ``row`` of ``knob_vectors`` samples with ``params``."""
    knobs["temperature"][row] = params.temperature
    knobs["top_k"][row] = params.top_k
    knobs["top_p"][row] = params.top_p
    knobs["seed"][row] = np.uint32(params.seed)


# Extra trailing tokens decoded beyond the longest stop string: slack for
# tokenizers where a token renders to fewer bytes than one character (BPE
# continuation pieces, held-back incomplete UTF-8 sequences).
_HELD_BACK_TOKENS = 4


def _stop_window(params: SamplingParams) -> int:
    """Tail-window size (in tokens) that bounds every stop-string match
    completed by the newest token: the longest stop is ``L`` characters,
    a token renders to >= 1 character in the common case, and
    ``_HELD_BACK_TOKENS`` covers the byte-thin stragglers."""
    return max(len(s) for s in params.stop) + _HELD_BACK_TOKENS


def finish_reason(token_ids: Sequence[int], params: SamplingParams,
                  max_new_tokens: int,
                  detokenizer: Optional[Callable] = None) -> str:
    """Finish condition after the LAST appended token: "stop" (stop token
    id, or a stop string appearing in the detokenized output), "length"
    (budget exhausted), or "" (keep decoding). Stop wins over length when
    both trigger on the same token.

    Stop-string matching is INCREMENTAL: this is called once per appended
    token (the engine's per-step check and ``scan_finish`` both do), so a
    match completing at token n must involve text the newest token
    contributed. Only the trailing ``_stop_window(params)`` tokens are
    re-detokenized — O(len(stop)) per token instead of re-rendering the
    whole output (O(n^2) per request). Matches confined to older text
    were already caught by the call that appended their final token."""
    if token_ids:
        if params.stop_token_ids and \
                int(token_ids[-1]) in params.stop_token_ids:
            return FINISH_STOP
        if params.stop and detokenizer is not None:
            tail = list(token_ids)[-_stop_window(params):]
            text = detokenizer(tail)
            if any(s in text for s in params.stop):
                return FINISH_STOP
    if len(token_ids) >= max_new_tokens:
        return FINISH_LENGTH
    return ""


def scan_finish(token_ids: Sequence[int], params: SamplingParams,
                max_new_tokens: int,
                detokenizer: Optional[Callable] = None
                ) -> Tuple[List[int], str]:
    """Scan a token list from the front and truncate at the FIRST finish
    condition — the batch-append path (snapshot replay, cohort lockstep
    output) must land on exactly the tokens the incremental per-token
    check would have kept. Returns (possibly-truncated tokens, reason);
    reason is "" only when no condition has triggered yet."""
    out: List[int] = []
    for t in token_ids:
        out.append(int(t))
        r = finish_reason(out, params, max_new_tokens, detokenizer)
        if r:
            return out, r
    return out, ""
