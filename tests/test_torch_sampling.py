"""The port's seeded top-k / top-p sampler (``launch.steps.make_sampler``)
against the JAX package's, on the CPU.

Greedy rows are held bit for bit (the raw-logits argmax). The candidate
set and its masked log-probabilities are held at 1e-6 against the
reference's rule (``repro/launch/steps.py``'s ``one``), restated in jnp
here. The draws cannot be held token for token: the reference draws from
``jax.random``, the port from Philox keyed by (seed, count). So each package's
20,000 draws over seeds are held to the exact distribution of that
support, each within total variation 0.03, and the port's draws are held
deterministic in (seed, count). ``SamplingParams`` and the finish rules
are the cases of ``tests/test_sampling.py``.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.launch import steps as jsteps
from repro_torch.launch import steps as tsteps
from repro_torch.serving.sampling import (SamplingParams, finish_reason,
                                          scan_finish)

V, CAP = 64, 256
N_DRAWS = 20_000
TV_TOL = 0.03


def _logits(rng, rows, v=V):
    return rng.normal(0.0, 2.0, size=(rows, v)).astype(np.float32)


def _port_sample(logits, temp, k, p, seed, count):
    n = logits.shape[0]
    full = lambda x, dt: np.broadcast_to(np.asarray(x, dt), (n,)).copy()
    return tsteps.make_sampler(CAP)(
        torch.from_numpy(logits), full(temp, np.float32), full(k, np.int32),
        full(p, np.float32), full(seed, np.uint32),
        full(count, np.int64)).numpy()


def _ref_sample(logits, temp, k, p, seed, count):
    n = logits.shape[0]
    full = lambda x, dt: jnp.asarray(np.broadcast_to(np.asarray(x, dt), (n,)))
    return np.asarray(jax.jit(jsteps.make_sampler(CAP))(
        jnp.asarray(logits), full(temp, np.float32), full(k, np.int32),
        full(p, np.float32), full(seed, np.uint32), full(count, np.int32)))


def _ref_candidates(row, t, k, p):
    """``repro/launch/steps.py``'s keep rule for one row, in jnp: the top
    ``cap`` scaled logits, probabilities against the full row, top-k then
    nucleus, rank 0 kept; returned as (ids, keep, log-probs)."""
    cap = min(CAP, row.shape[-1])
    scaled = row / jnp.maximum(t, 1e-6)
    sl, idx = jax.lax.top_k(scaled, cap)
    logp = sl - jax.nn.logsumexp(scaled)
    probs = jnp.exp(logp)
    cum = jnp.cumsum(probs)
    keep = jnp.arange(cap) < jnp.where(k > 0, k, cap)
    keep &= (cum - probs) < p
    keep = keep.at[0].set(True)
    return np.asarray(idx), np.asarray(keep), np.asarray(logp)


def test_greedy_rows_are_the_argmax_bitwise(rng):
    logits = _logits(rng, 8)
    want = torch.argmax(torch.from_numpy(logits), dim=-1).numpy()
    for k, p, seed in ((0, 1.0, 0), (3, 0.5, 7), (64, 0.01, 123)):
        got = _port_sample(logits, 0.0, k, p, seed, np.arange(8))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, _ref_sample(logits, 0.0, k, p, seed, np.arange(8)))
    # a mixed batch: the greedy rows stay the argmax, the sampling rows
    # draw exactly as they do alone
    temps = np.array([0, 1.5, 0, 0.7, 0, 0, 2.0, 0], np.float32)
    sample = tsteps.make_sampler(CAP)
    mixed = sample(torch.from_numpy(logits), temps, np.zeros(8, np.int32),
                   np.ones(8, np.float32), np.arange(8, dtype=np.uint32),
                   np.full(8, 3)).numpy()
    np.testing.assert_array_equal(mixed[temps == 0], want[temps == 0])
    for i in np.flatnonzero(temps):
        alone = _port_sample(logits[i:i + 1], temps[i], 0, 1.0, i, 3)
        assert mixed[i] == alone[0]


def test_top_k_one_is_the_argmax_at_high_temperature(rng):
    logits = _logits(rng, 4)
    want = np.argmax(logits, -1)
    for seed in range(5):
        np.testing.assert_array_equal(
            _port_sample(logits, 5.0, 1, 1.0, seed, 0), want)
        np.testing.assert_array_equal(
            _ref_sample(logits, 5.0, 1, 1.0, seed, 0), want)


@pytest.mark.parametrize("t,k,p", [(1.0, 0, 1.0), (0.8, 16, 0.95),
                                   (1.3, 0, 0.5), (0.5, 5, 0.9),
                                   (2.0, 40, 0.3)])
@pytest.mark.parametrize("v", [V, 1000, 32000])
def test_candidates_match_the_reference_rule(rng, t, k, p, v):
    """At V = 32000 the logits are bf16 values (a bf16 model's logits in
    fp32), so the top 256 hold exact ties: the port orders them by id, as
    ``lax.top_k`` does, on any device."""
    logits = _logits(rng, 3, v)
    if v == 32000:
        logits = torch.from_numpy(logits).bfloat16().float().numpy()
        assert len(np.unique(np.sort(logits, -1)[:, -256:])) < 3 * 256
    ids, masked = tsteps.sample_candidates(
        torch.from_numpy(logits), torch.full((3,), t),
        torch.full((3,), k), torch.full((3,), p), CAP)
    assert ids.shape == (3, min(CAP, v))
    for r in range(3):
        jid, jkeep, jlogp = _ref_candidates(jnp.asarray(logits[r]), t, k, p)
        np.testing.assert_array_equal(ids[r].numpy(), jid)
        np.testing.assert_array_equal(torch.isfinite(masked[r]).numpy(),
                                      jkeep)
        np.testing.assert_allclose(masked[r].numpy()[jkeep], jlogp[jkeep],
                                   atol=1e-6, rtol=1e-6)


def _exact_dist(row, t, k, p):
    """The sampler's exact distribution over token ids (zeros outside
    the kept support), from the reference's keep rule."""
    ids, keep, logp = _ref_candidates(jnp.asarray(row), t, k, p)
    w = np.exp(logp[keep].astype(np.float64))
    dist = np.zeros(row.shape[-1])
    dist[ids[keep]] = w / w.sum()
    return dist


@pytest.mark.parametrize("t,k,p", [(0.8, 16, 0.95), (1.0, 0, 0.7),
                                   (1.5, 6, 1.0)])
def test_draws_follow_the_masked_distribution(rng, t, k, p):
    """20,000 draws over seeds from each package lie inside the kept
    support and within total variation 0.03 of its exact distribution."""
    row = _logits(rng, 1)[0]
    want = _exact_dist(row, t, k, p)
    rows = np.broadcast_to(row, (N_DRAWS, V)).copy()
    seeds = np.arange(N_DRAWS)
    for draws in (_port_sample(rows, t, k, p, seeds, 0),
                  _ref_sample(rows, t, k, p, seeds, 0)):
        assert want[draws].min() > 0, "a draw outside the support"
        emp = np.bincount(draws, minlength=V) / N_DRAWS
        assert 0.5 * np.abs(emp - want).sum() < TV_TOL


def test_draws_are_keyed_by_seed_and_count(rng):
    """The same (seed, count) gives the same token, whatever the row's
    position in the batch; counts and seeds decorrelate."""
    logits = _logits(rng, 4)
    a = _port_sample(logits, 1.0, 0, 0.9, 3, 5)
    np.testing.assert_array_equal(a, _port_sample(logits, 1.0, 0, 0.9, 3, 5))
    flipped = _port_sample(logits[::-1].copy(), 1.0, 0, 0.9, 3, 5)
    np.testing.assert_array_equal(a, flipped[::-1])
    by_count = {tuple(_port_sample(logits, 1.5, 0, 1.0, 3, c))
                for c in range(8)}
    by_seed = {tuple(_port_sample(logits, 1.5, 0, 1.0, s, 0))
               for s in range(8)}
    assert len(by_count) > 1 and len(by_seed) > 1
    # the noise is made on the host from (seed, count) alone
    g1 = tsteps.gumbel_noise([3, 2 ** 32 - 1], [5, 0], 16)
    g2 = tsteps.gumbel_noise([2 ** 32 - 1, 3], [0, 5], 16)
    assert torch.equal(g1, g2.flip(0))
    assert not torch.equal(g1[0], tsteps.gumbel_noise([3], [6], 16)[0])


def test_sampling_params_validation():
    SamplingParams(temperature=0.7, top_k=5, top_p=0.9)
    for bad in (dict(temperature=-0.1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5), dict(max_new_tokens=0)):
        with pytest.raises(ValueError):
            SamplingParams(**bad)
    assert SamplingParams().greedy
    assert not SamplingParams(temperature=0.5).greedy


def test_finish_reason_stop_and_length():
    sp = SamplingParams(stop_token_ids=(9,))
    assert finish_reason([1, 2], sp, 8) == ""
    assert finish_reason([1, 9], sp, 8) == "stop"
    assert finish_reason([1, 2], sp, 2) == "length"
    assert finish_reason([1, 9], sp, 2) == "stop"   # stop wins over length
    toks, reason = scan_finish([1, 9, 3, 4], sp, 8)
    assert toks == [1, 9] and reason == "stop"
    detok = lambda ids: " ".join(map(str, ids))
    toks, reason = scan_finish([1, 2, 3, 4], SamplingParams(stop=("2 3",)),
                               8, detok)
    assert toks == [1, 2, 3] and reason == "stop"
