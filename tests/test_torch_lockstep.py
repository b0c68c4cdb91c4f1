"""Lockstep of the port's serving engine with the JAX package's, shared by
the arch tests (``test_torch_qk_norm.py``, ``test_torch_moe.py``,
``test_torch_frontends.py``).

The reference engine serves the traffic first, recording the logits and
the token of every pick and the membership of every CLUSTER; the port's
engine then serves the same traffic taking the reference's tokens and
memberships, so both run the same sequences. Each pick's logits are held
on the live rows, and the port's own greedy pick wherever the
reference's top-2 margin clears ``margin``.
"""
import numpy as np
import torch

from repro.core import cache as jcache
from repro_torch.core import cache as tcache

TOL = dict(atol=1e-4, rtol=1e-4)
MARGIN = 1e-3


def live_rows(eng, n, prefill_phase):
    """The rows of a pick whose logits mean something: every row of a
    cohort or a batch-1 prefill, else the occupied slots not in PREFILL."""
    if n == 1 or eng.ecfg.scheduler == "cohort":
        return list(range(n))
    return [i for i, r in enumerate(eng._slot_req)
            if r is not None and eng._phases[i] != prefill_phase]


def record_reference(jeng):
    """Wrap the reference engine's argmax and CLUSTER: returns the lists
    they fill, (logits, tokens, live rows) per pick and the membership
    per CLUSTER (batch-free for a slot, batched for a cohort)."""
    calls, idents = [], []
    argmax = jeng._argmax

    def rec_argmax(lg):
        out = argmax(lg)
        rows = live_rows(jeng, lg.shape[0], jcache.PHASE_PREFILL)
        calls.append((np.asarray(lg), np.asarray(out), rows))
        return out
    jeng._argmax = rec_argmax
    if jeng.chai_on and jeng.ecfg.scheduler == "cohort":
        identify = jeng._identify

        def rec_identify(sc):
            out = identify(sc)
            idents.append({k: np.array(v) for k, v in out.items()})
            return out
        jeng._identify = rec_identify
    elif jeng.chai_on:
        cluster = jeng._cluster_fn()

        def rec_cluster(state, ctx, slot, *rest):
            state, ctx = cluster(state, ctx, slot, *rest)
            idents.append({k: np.array(v[:, int(slot)])[:, None]
                           for k, v in ctx.items()})
            return state, ctx
        jeng._cluster_slot = rec_cluster
    return calls, idents


def replay_on_port(teng, calls, idents, *, tol=TOL, margin=MARGIN):
    """Make the port's engine take the recorded tokens and memberships and
    hold its logits; returns the list the margin-checked picks fill."""
    checked = []

    def port_argmax(lg):
        jlg, jtok, rows = calls.pop(0)
        assert tuple(lg.shape) == jlg.shape
        assert rows == live_rows(teng, lg.shape[0], tcache.PHASE_PREFILL)
        np.testing.assert_allclose(lg.numpy()[rows], jlg[rows], **tol)
        own = torch.argmax(lg, dim=-1).numpy()
        for i in rows:
            top2 = np.sort(jlg[i])[-2:]
            if top2[1] - top2[0] > margin:
                assert own[i] == jtok[i]
                checked.append(1)
        return torch.from_numpy(jtok.astype(np.int64))

    teng._argmax = port_argmax
    teng._identify = lambda sc: {k: torch.from_numpy(v)
                                 for k, v in idents.pop(0).items()}
    return checked


def serve_in_lockstep(jeng, teng, waves, *, tol=TOL, margin=MARGIN):
    """Serve ``waves`` (lists of (uid, prompt, max_new); each wave runs
    to idle before the next is submitted) on the reference engine, then
    on the port's in lockstep with it. Returns (tokens by uid, the number
    of margin-checked picks, the number of CLUSTERs)."""
    calls, idents = record_reference(jeng)
    for wave in waves:
        for uid, prompt, max_new in wave:
            jeng.submit(prompt, max_new_tokens=max_new, uid=uid)
        jeng.run()
    n_cluster = len(idents)
    checked = replay_on_port(teng, calls, idents, tol=tol, margin=margin)
    for wave in waves:
        for uid, prompt, max_new in wave:
            teng.submit(prompt, max_new_tokens=max_new, uid=uid)
        teng.run()
    assert not calls and not idents
    tdone = {r.uid: r.generated for r in teng.done}
    assert tdone == {r.uid: r.generated for r in jeng.done}
    return tdone, len(checked), n_cluster
