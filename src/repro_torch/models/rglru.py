"""RecurrentGemma recurrent block: temporal conv + RG-LRU (Griffin).

The reference's ``models/rglru.py`` in torch ops. Its full-sequence path
runs the linear recurrence h_t = a_t * h_{t-1} + b_t as a parallel
prefix (``lax.associative_scan``); torch has no such primitive, so
``linear_scan`` is a log-depth doubling scan in fp32 (ceil(log2 T)
rounds of a few elementwise ops over the whole sequence, never a loop
over T). Its sums are ordered otherwise than XLA's, so the two agree to
rounding, not bit for bit. Decode is a single step. State: (h,
conv_tail), both in the model dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_C = 8.0  # Griffin's fixed recurrence sharpness constant


def _gates(x_br, p):
    """Recurrence gate a_t (as its log) and input gate i_t from the x
    branch. ``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus``
    returns x itself above its threshold of 20, where the two differ by
    under 3e-9."""
    r = torch.sigmoid(x_br @ p["w_a"])
    i = torch.sigmoid(x_br @ p["w_i"])
    log_a = -_C * F.softplus(p["log_lambda"]) * r           # (..., rnn)
    return log_a, i


def _causal_conv_full(x, w, b):
    """x: (B, T, D); w: (cw, D) depthwise causal conv; b: (D,). Tap
    ``w[cw - 1 - i]`` weights the input i steps before the last, in the
    reference's order."""
    cw, t = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, cw - 1, 0))
    out = torch.zeros_like(x)
    for i in range(cw):  # cw is small (4): unrolled taps
        out = out + pad[:, i: i + t] * w[cw - 1 - i]
    return out + b


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along axis 1 from h_{-1} = 0, for fp32
    a, b (B, T, ...): the inclusive scan of the reference's ``combine``
    ((a1, b1), (a2, b2)) -> (a1 a2, a2 b1 + b2), by doubling: at stride
    d every position t >= d folds in the prefix ending at t - d. Each
    round reads the previous round's tensors and builds new ones, so no
    write aliases a read."""
    d, t = 1, a.shape[1]
    while d < t:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_fullseq(x, p, cfg, h0=None, conv_tail=None):
    """x: (B, T, d) -> (y, (h_T, conv_tail)).

    h0: (B, rnn) initial state, folded in as a virtual step at t = -1
    with a = 0, b = h0; conv_tail: (B, cw-1, rnn) trailing inputs."""
    xb = x @ p["w_x"]                                        # (B, T, rnn)
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")

    if conv_tail is not None:
        xb_ext = torch.cat([conv_tail, xb], dim=1)
        xb_conv = _causal_conv_full(xb_ext, p["conv_w"], p["conv_b"])
        xb_conv = xb_conv[:, conv_tail.shape[1]:]
    else:
        xb_conv = _causal_conv_full(xb, p["conv_w"], p["conv_b"])

    log_a, i_gate = _gates(xb_conv, p)                       # (B, T, rnn)
    a = torch.exp(log_a.float())
    gated_x = (i_gate * xb_conv).float()
    b_t = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) * gated_x

    if h0 is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b_t = torch.cat([h0.float()[:, None], b_t], dim=1)
    h = linear_scan(a, b_t)
    if h0 is not None:
        h = h[:, 1:]
    h = h.to(x.dtype)

    y = (h * gate) @ p["w_out"]
    tail = xb if conv_tail is None else torch.cat([conv_tail, xb], dim=1)
    return y, (h[:, -1], tail[:, -(cfg.conv_width - 1):])


def rglru_decode(x, p, cfg, h, conv_tail):
    """One-step decode. x: (B, d); h: (B, rnn); conv_tail: (B, cw-1, rnn).
    The window is time-ordered (oldest first) and ``conv_w[j]`` weights
    the token j steps back, so the taps are flipped to align with the
    full-sequence conv."""
    xb = x @ p["w_x"]
    gate = F.gelu(x @ p["w_gate"], approximate="tanh")
    window = torch.cat([conv_tail, xb[:, None]], dim=1)     # (B, cw, rnn)
    xb_conv = torch.einsum("bcw,cw->bw", window,
                           p["conv_w"].flip(0)) + p["conv_b"]
    log_a, i_gate = _gates(xb_conv, p)
    a = torch.exp(log_a.float())
    b_t = (torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12))
           * (i_gate * xb_conv).float())
    h_new = (a * h.float() + b_t).to(x.dtype)
    y = (h_new * gate) @ p["w_out"]
    return y, (h_new, window[:, 1:])
