"""CHAI's offline phase (paper §3.2, Figs 8 and 10a): elbow analysis per
layer.

``python -m repro_torch.launch.offline_clustering [--reduced] [--device]``

Collects per-head attention-score features over calibration sequences (a
prefill, then ``cfg.chai.warmup_tokens`` MHA decode steps accumulating the
score buffer, as serving's WARMUP does), sweeps K-Means k = 1..H per
layer, and prints each layer's error curve, the elbow-selected cluster
counts beside the config's frozen ones, and each layer's mean absolute
off-diagonal head correlation. Random weights from a seed; calibration
tokens from a numpy seed (``offline_phase`` takes any token batches).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as chai_cache
from repro_torch.core.clustering import standardize
from repro_torch.core.correlation import head_correlation, mean_abs_offdiag
from repro_torch.core.elbow import elbow_curve, select_k
from repro_torch.models import transformer as tfm


def calibration_features(params, cfg, batches, *, max_seq=64, device=None):
    """Mean WARMUP score buffer over the calibration sequences: (nA, H, Wf)
    fp32 on ``device``. ``batches``: token arrays (B, T); each takes a
    prefill into a fresh dense state, then ``warmup_tokens`` MHA decode
    steps, the first fed the prompt's last token, then greedy."""
    dev = resolve_device(device)
    feats, n = None, 0
    for toks in batches:
        toks = torch.as_tensor(np.asarray(toks), dtype=torch.long,
                               device=dev)
        state = tfm.init_decode_state(cfg, toks.shape[0], max_seq, dev)
        _, state = tfm.forward_fullseq(params, cfg, toks, state=state,
                                       logits_slice="last")
        state = chai_cache.add_score_buffer(state, cfg, toks.shape[0])
        nxt = toks[:, -1]
        for _ in range(cfg.chai.warmup_tokens):
            logits, state = tfm.decode_step(params, cfg, nxt, state)
            nxt = torch.argmax(logits, dim=-1)
        _, scores = chai_cache.pop_score_buffer(state)     # (nA, B, H, Wf)
        s = scores.sum(dim=1)
        feats = s if feats is None else feats + s
        n += scores.shape[1]
    return feats / n


def elbow_analysis(features, plateau_tol=0.05):
    """features (nA, H, F) -> {"ks", "curves" (nA, len(ks)) float64,
    "counts" [nA], "offdiag" [nA]}: the elbow over k = 1..H of each
    layer's standardized features, and its mean |off-diagonal| head
    correlation."""
    ks = list(range(1, features.shape[1] + 1))
    curves = elbow_curve(standardize(features), ks)
    return {"ks": ks, "curves": curves,
            "counts": [int(select_k(c, ks, plateau_tol)) for c in curves],
            "offdiag": [float(mean_abs_offdiag(head_correlation(f)))
                        for f in features]}


def offline_phase(params, cfg, batches, *, max_seq=64, plateau_tol=0.05,
                  device=None):
    """The whole offline phase: ``elbow_analysis`` of
    ``calibration_features``, with the features under ``"features"``."""
    feats = calibration_features(params, cfg, batches, max_seq=max_seq,
                                 device=device)
    return {"features": feats, **elbow_analysis(feats, plateau_tol)}


def calibration_tokens(vocab, seq_len, n_samples, batch=8, seed=0):
    """Calibration token batches from a numpy seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(n_samples, seq_len))
    return [toks[i:i + batch] for i in range(0, n_samples, batch)]


# The model and the calibration batch the entry runs.
ARCH, N_SAMPLES, SEQ_LEN = "chai-llama-7b", 16, 24


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU-sized reduced config (4 layers, 8 heads)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(ARCH)
    if args.reduced:
        cfg = reduced(cfg)
    params = tfm.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
    print(f"[offline] {cfg.name}: {cfg.n_layers} layers, {cfg.n_heads} "
          f"heads; {N_SAMPLES} calibration sequences of {SEQ_LEN} "
          f"tokens on {device}")
    out = offline_phase(params, cfg, calibration_tokens(
        cfg.vocab_size, SEQ_LEN, N_SAMPLES), device=device)
    print(f"{'layer':>6} {'k':>4} {'offdiag':>8}   error curve (k = 1..H)")
    for li, (k, off, curve) in enumerate(zip(out["counts"], out["offdiag"],
                                             out["curves"])):
        print(f"{li:>6} {k:>4} {off:8.4f}   "
              + " ".join(f"{e:.2f}" for e in curve))
    print(f"cluster_counts = {tuple(out['counts'])}")
    print(f"the config's frozen counts = {cfg.chai_cluster_counts()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
