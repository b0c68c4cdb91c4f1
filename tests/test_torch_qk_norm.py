"""The port's ``qk_norm`` and gemma3-4b, and the decode kernels' plain
versions at head dim 320, against the JAX package's, on the CPU.

* ``project_qkv`` with ``qk_norm``: q and k RMS-normed per head by
  random ``q_norm`` / ``k_norm`` scales, after the projection and before
  RoPE, at 1e-5.
* The CHAI decode with ``qk_norm``, teacher-forced through prefill, three
  WARMUP steps and STEADY steps (the membership from the reference's
  score buffer): GQA per request, and MHA per request and shared (the
  reference normalizes before the gather of representative heads in one
  branch and after it in the other), every row on row 0's membership;
  logits at 1e-4. The norm is per head, so it commutes with the gather:
  the port's shared and per-request membership give the same logits.
* Reduced gemma3-4b (a local and a global layer, 8 heads over 4 KV
  groups, window 8, fp32): the cohort engine and the continuous engine,
  paged and dense, CHAI on and the MHA baseline, in lockstep with the
  reference's (``test_torch_lockstep``). gemma3 has local layers, so both
  packages refuse it the prefix cache and chunked prefill.
* The four decode kernels gemma3's global layers reach at head dim 320
  (``chai_fused_decode``, ``paged_chai_fused_decode``, ``flash_decode``,
  ``paged_decode``): their plain versions against the Pallas kernels in
  interpret mode at gemma3's layout (GQA 8/4, two reps a group), at the
  reference tests' tolerances; paged == dense bitwise at ts == page.
* The CUDA wrappers take head dim 320 (the fused pair on its wide-head
  libraries, every K/V pairing; the relay kernel; the flash decode pair
  on its wide instance) and still refuse a head dim that is not a
  multiple of 8 or one above 256 but 320 (shapes only, meta tensors).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.core import cache as jcache
from repro.core import clustering as jclust
from repro.kernels import chai_attention as jck
from repro.kernels import flash_attention as jfk
from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import cache as tcache
from repro_torch.core import clustering as tclust
from repro_torch.kernels import chai_attention as tck
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy
from test_torch_lockstep import serve_in_lockstep

TOL = dict(atol=1e-4, rtol=1e-4)
STATE_TOL = dict(atol=1e-5, rtol=1e-5)
# the reference's kernel tests: the fused decode at 1e-5 (fp32), the
# flash decode at 2e-3 (tests/test_kernels.py: TOL)
FUSED_TOL = dict(atol=1e-5, rtol=1e-5)
FLASH_TOL = dict(atol=2e-3, rtol=2e-3)
GEMMA3 = "gemma3-4b"
HD = 320


def _t(a):
    return torch.from_numpy(np.array(a))


def _with_norm_scales(jparams, seed):
    """The reference's weights with random q_norm / k_norm scales (their
    init is zero, a scale of one)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.asarray, jparams)
    for name in ("q_norm", "k_norm"):
        shape = out["attn"][name].shape
        out["attn"][name] = rng.normal(0, 0.5, shape).astype(np.float32)
    return out


_MODELS = {}


def _models(arch, red, rep=None, seed=0):
    """(reference config, port config, reference weights, the same weights
    in the port), built once per module: the reference's ``init_params``
    compiles per leaf and dominates a small test's time."""
    key = (arch, tuple(sorted(red.items())),
           tuple(sorted((rep or {}).items())), seed)
    if key not in _MODELS:
        jcfg = jreduced(jget_config(arch), **red).replace(**(rep or {}))
        tcfg = reduced(get_config(arch), **red).replace(**(rep or {}))
        jp = _with_norm_scales(
            jtfm.init_params(jcfg, jax.random.PRNGKey(seed)), seed)
        _MODELS[key] = (jcfg, tcfg, jax.tree.map(jnp.asarray, jp),
                        params_from_numpy(jp, device="cpu"))
    return _MODELS[key]


# ----------------------------------------------------- project_qkv ----
def test_project_qkv_matches_reference():
    jcfg, tcfg, jparams, tparams = _models(GEMMA3, dict(n_layers=2,
                                                        window=8))
    assert tcfg.qk_norm and jcfg.qk_norm
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, tcfg.d_model)).astype(np.float32)
    positions = np.arange(3, 10, dtype=np.int32)
    jp = {k: v[0] for k, v in jparams["attn"].items()}
    tp = {k: v[0] for k, v in tparams["attn"].items()}
    want = jattn.project_qkv(jnp.asarray(x), jp, jcfg,
                             jnp.asarray(positions))
    got = tattn.project_qkv(_t(x), tp, tcfg, _t(positions))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE_TOL)
    # the norm is live: without it q and k move, v does not
    plain = tattn.project_qkv(_t(x), tp, tcfg.replace(qk_norm=False),
                              _t(positions))
    assert not torch.allclose(plain[0], got[0], atol=1e-3)
    assert not torch.allclose(plain[1], got[1], atol=1e-3)
    assert torch.equal(plain[2], got[2])


# -------------------------------------------------- the CHAI decode ----
CHAI_CASES = {
    # an MHA arch with qk_norm (musicgen's layout, the norm switched on)
    "mha": ("musicgen-large", dict(n_layers=2), dict(qk_norm=True)),
    # GQA 8/4 with qk_norm and a local layer: reduced gemma3
    "gqa": (GEMMA3, dict(n_layers=2, window=8), {}),
}


_JSTEPS = {}         # the reference's jitted decode step, one a case


def _steady_run(case, membership):
    """Prefill 12 tokens in 2 rows, 3 teacher-forced WARMUP steps, the
    reference's membership from its score buffer (``membership``:
    "batched"; "shared": row 0's membership shared by every row;
    "rows_equal": row 0's membership per request), then 3 STEADY steps; both packages' logits held at 1e-4. Returns the port's
    STEADY logits."""
    arch, red, rep = CHAI_CASES[case]
    jcfg, tcfg, jparams, tparams = _models(arch, red, rep)
    jcfg = jcfg.with_chai(enabled=True, warmup_tokens=3)
    tcfg = tcfg.with_chai(enabled=True, warmup_tokens=3)
    b, s = 2, 32
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (b, 12))
    nxt = rng.integers(0, jcfg.vocab_size, (6, b))
    js = jtfm.init_decode_state(jcfg, b, s)
    _, js, _ = jtfm.forward_fullseq(jparams, jcfg, jnp.asarray(toks),
                                    state=js, logits_slice="last")
    ts = ttfm.init_decode_state(tcfg, b, s, "cpu")
    _, ts = ttfm.forward_fullseq(tparams, tcfg, _t(toks), state=ts,
                                 logits_slice="last")
    js = jcache.add_score_buffer(js, jcfg, b)
    ts = tcache.add_score_buffer(ts, tcfg, b)
    if case not in _JSTEPS:
        _JSTEPS[case] = jax.jit(lambda p, tok, st, ctx: jtfm.decode_step(
            p, jcfg, tok, st, chai_ctx=ctx))
    jstep = _JSTEPS[case]
    out = []
    jctx = tctx = None
    for i in range(6):
        if i == 3:
            js, jsc = jcache.pop_score_buffer(js)
            ts, tsc = tcache.pop_score_buffer(ts)
            np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                       atol=1e-5, rtol=1e-4)
            jctx = jclust.identify_membership(jsc, jcfg)
            tctx = tclust.identify_membership(_t(jsc), tcfg)
            for key in jctx:
                np.testing.assert_array_equal(tctx[key].numpy(),
                                              np.asarray(jctx[key]))
            if membership == "shared":
                jctx = {k: v[:, 0] for k, v in jctx.items()}
                tctx = {k: v[:, 0] for k, v in tctx.items()}
            elif membership == "rows_equal":
                tctx = {k: v[:, :1].expand(v.shape).contiguous()
                        for k, v in tctx.items()}
                jctx = {k: jnp.asarray(v.numpy()) for k, v in tctx.items()}
            if tcfg.is_mha:
                js = jcache.compact_kv(js, jctx, jcfg)
                ts = tcache.compact_kv(ts, tctx, tcfg)
        jl, js = jstep(jparams, jnp.asarray(nxt[i]), js, jctx)
        tl, ts = ttfm.decode_step(tparams, tcfg, _t(nxt[i]), ts,
                                  chai_ctx=tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"{case} {membership} step {i}")
        if i >= 3:
            out.append(tl)
    return torch.stack(out)


def test_gqa_chai_decode_with_qk_norm_matches_reference():
    _steady_run("gqa", "batched")


def test_mha_qk_norm_commutes_with_the_gather():
    """MHA: every row on row 0's membership, once per request (the norm
    over all heads, then the gather) and once shared (the gather of the
    reps' weight rows, then the norm), each held against the reference
    on the same membership: the same STEADY logits."""
    batched = _steady_run("mha", "rows_equal")
    shared = _steady_run("mha", "shared")
    np.testing.assert_allclose(batched[:, :1].numpy(), shared[:, :1].numpy(),
                               atol=1e-5, rtol=1e-5)


# ------------------------------------------------ gemma3, the engines ----
ENGINES = {"cohort": dict(scheduler="cohort"),
           "paged": dict(kv_layout="paged"),
           "dense": dict(kv_layout="dense")}
PROMPT_LENS = (11, 17, 14)
BUDGETS = (7, 6, 5)


@pytest.fixture(scope="module")
def gemma3():
    jcfg, tcfg, jparams, tparams = _models(GEMMA3, dict(n_layers=2,
                                                        window=8))
    assert tcfg.layer_types == jcfg.layer_types == ("attn_local",
                                                    "attn_global")
    assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.qk_norm) == (8, 4, True)
    return jcfg, tcfg, jparams, tparams


def _ecfg(cls, ekw):
    return cls(**dict(batch_slots=2, max_seq=64, page_size=16, **ekw))


@pytest.mark.parametrize("chai", [True, False], ids=["chai", "mha"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_gemma3_engines_in_lockstep_with_reference(gemma3, engine, chai):
    """The prompts of 11 to 17 tokens pass the window of 8; CHAI on,
    requests cluster after their WARMUP."""
    jcfg, tcfg, jparams, tparams = gemma3
    ekw = dict(ENGINES[engine], use_chai=chai)
    jeng = JServingEngine(jcfg, jparams, _ecfg(JEngineConfig, ekw))
    teng = ServingEngine(tcfg, tparams, _ecfg(EngineConfig, ekw),
                         device="cpu")
    rng = np.random.default_rng(0)
    wave = [(i, rng.integers(0, tcfg.vocab_size, size=n), m)
            for i, (n, m) in enumerate(zip(PROMPT_LENS, BUDGETS))]
    done, checked, n_cluster = serve_in_lockstep(jeng, teng, [wave])
    assert [len(done[i]) for i in range(3)] == list(BUDGETS)
    assert checked >= 12
    assert (n_cluster > 0) == chai
    assert teng.paged == (engine == "paged")
    assert teng.kv_bytes() == jeng.kv_bytes()


@pytest.mark.parametrize("kw", [dict(prefix_cache=True),
                                dict(prefill_chunk_tokens=16)],
                         ids=["prefix_cache", "chunked"])
def test_gemma3_refuses_prefix_cache_and_chunks(gemma3, kw):
    """Local rings are not paged: both packages refuse gemma3 the prefix
    cache and chunked prefill, with the same message."""
    jcfg, tcfg, jparams, tparams = gemma3
    msgs = []
    for make in (lambda: JServingEngine(jcfg, jparams,
                                        _ecfg(JEngineConfig, kw)),
                 lambda: ServingEngine(tcfg, tparams,
                                       _ecfg(EngineConfig, kw),
                                       device="cpu")):
        with pytest.raises(ValueError) as err:
            make()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] and "global-attention-only" in msgs[0]


# -------------------------------------- the decode kernels at hd 320 ----
def _fused_inputs(seed, *, b=2, h=8, kv=4, rpg=2, s=64, pos=(17, 63)):
    """gemma3's global-layer layout: 8 heads over 4 KV groups, two reps a
    group, head h picking a rep of its own group."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, kv * rpg, HD)).astype(np.float32)
    k = rng.normal(size=(b, kv, s, HD)).astype(np.float32)
    v = rng.normal(size=(b, kv, s, HD)).astype(np.float32)
    grp = np.arange(h) // (h // kv)
    h2c = (grp[None, :] * rpg + rng.integers(0, rpg, size=(b, h))).astype(
        np.int32)
    return q, k, v, h2c, np.asarray(pos, np.int32)


def _pool_of(rng, k, v, page):
    """A pool holding the dense K and V pages at shuffled ids (random
    values elsewhere, page 0 poisoned) and their tables."""
    b, kv, s, hd = k.shape
    n = s // page
    n_pool = 2 * b * n + 3
    pool = rng.normal(size=(n_pool, kv, page, hd)).astype(np.float32)
    pool[0] = 999.0
    perm = rng.permutation(np.arange(1, n_pool))[:2 * b * n]
    bt_k, bt_v = perm.reshape(2, b, n).astype(np.int32)
    pool[bt_k] = k.reshape(b, kv, n, page, hd).transpose(0, 2, 1, 3, 4)
    pool[bt_v] = v.reshape(b, kv, n, page, hd).transpose(0, 2, 1, 3, 4)
    return pool, bt_k, bt_v


def test_fused_pair_plain_at_hd320_matches_pallas():
    q, k, v, h2c, pos = _fused_inputs(0)
    page = 16
    want = jck.chai_fused_decode(*(jnp.asarray(a) for a in
                                   (q, k, v, h2c, pos)),
                                 reps_per_group=2, ts=page)
    dense = tops.chai_decode_attention(*(_t(a) for a in (q, k, v, h2c, pos)),
                                       reps_per_group=2, ts=page)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want), **FUSED_TOL)
    pool, bt_k, bt_v = _pool_of(np.random.default_rng(1), k, v, page)
    jwant = jck.paged_chai_fused_decode(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(bt_k),
        jnp.asarray(pool), jnp.asarray(bt_v), jnp.asarray(h2c),
        jnp.asarray(pos), reps_per_group=2)
    paged = tops.paged_chai_decode_attention(
        _t(q), _t(pool), _t(bt_k), _t(pool), _t(bt_v), _t(h2c), _t(pos),
        reps_per_group=2)
    np.testing.assert_allclose(paged.numpy(), np.asarray(jwant), **FUSED_TOL)
    assert torch.equal(paged, dense)     # ts == page; null page masked
    # positions past pos are masked: new values there change nothing
    k2 = k.copy()
    k2[0, :, pos[0] + 1:] = 50.0
    again = tref.chai_fused_decode_ref(*(_t(a) for a in (q, k2, v, h2c, pos)),
                                       reps_per_group=2)
    np.testing.assert_allclose(again.numpy(), dense.numpy(), **FUSED_TOL)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_pair_plain_at_hd320_matches_pallas(dtype):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    rng = np.random.default_rng(2)
    b, h, kv, s, page = 2, 8, 4, 64, 16
    q = rng.normal(size=(b, h, HD)).astype(np.float32)
    k = rng.normal(size=(b, kv, s, HD)).astype(np.float32)
    v = rng.normal(size=(b, kv, s, HD)).astype(np.float32)
    pos = np.asarray([21, 63], np.int32)
    want = jfk.flash_decode(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                            jnp.asarray(pos), ts=page, interpret=True)
    dense = tops.flash_decode_attention(*(_t(a).to(tdt) for a in (q, k, v)),
                                        _t(pos), ts=page)
    tol = FLASH_TOL if dtype == "fp32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want, np.float32),
                               **tol)
    pool, bt_k, bt_v = _pool_of(rng, k, v, page)
    jwant = jfk.paged_decode(jnp.asarray(q, jdt), jnp.asarray(pool, jdt),
                             jnp.asarray(bt_k), jnp.asarray(bt_v),
                             jnp.asarray(pos), interpret=True)
    paged = tops.paged_decode_attention(_t(q).to(tdt), _t(pool).to(tdt),
                                        _t(bt_k), _t(bt_v), _t(pos))
    np.testing.assert_allclose(paged.numpy(), np.asarray(jwant, np.float32),
                               **tol)
    assert torch.equal(paged, dense)


META = dict(device="meta")


@pytest.mark.parametrize("hd,ok", [(320, True), (256, True), (128, True),
                                   (324, False), (328, False), (264, False)])
def test_fused_wrappers_take_hd320(hd, ok):
    """The fused pair's and the relay kernel's checks (shapes only): a
    multiple of 8 up to 256, or 320: the fused pair on its wide-head
    libraries, the serving pairings' (``_wide``) and the general
    pairings' (``_wide_kv``), the relay on its blocks at that head dim;
    264, 324 and 328 are refused on every body."""
    q = torch.empty(2, 8, hd, **META)
    k = torch.empty(2, 4, 64, hd, dtype=torch.bfloat16, **META)
    h2c = torch.empty(2, 8, dtype=torch.int32, **META)
    cfg, _ = tck.dense_launch_config(q, k, h2c, reps_per_group=2, ts=16)
    gcfg, _ = tck.dense_launch_config(q, k, h2c, reps_per_group=2, ts=16,
                                      general=True)
    pool = torch.empty(9, 4, 16, hd, dtype=torch.bfloat16, **META)
    bt = torch.empty(2, 4, dtype=torch.int32, **META)
    pcfg = tck.paged_launch_config(q, pool, bt, h2c, reps_per_group=2)
    assert pcfg == cfg
    rcfg = tck.relay_launch_config(2, 8, 16, 4, 4, 4)
    for name, c, rpg in (("chai_fused_decode", cfg, 2),
                         ("chai_fused_decode", gcfg, 2),
                         ("paged_chai_fused_decode", pcfg, 2),
                         ("relay_prefix_decode", rcfg, 1)):
        if ok:
            tck._check_block(name, hd, rpg, c)
        else:
            with pytest.raises(ValueError, match="multiple of 8"):
                tck._check_block(name, hd, rpg, c)
    if hd == 320:
        assert cfg.smem_bytes <= 48 * 1024
        assert gcfg.smem_bytes <= tck._SMEM_LIMIT
        for name in ("chai_fused_decode", "paged_chai_fused_decode"):
            assert tck._wide_lib(name, True, tck.KV_FLOAT) == f"{name}_wide"
            assert tck._wide_lib(name, True, tck.KV_INT8) == f"{name}_wide"
            assert (tck._wide_lib(name, True, tck.KV_GENERAL)
                    == f"{name}_wide_kv")
            assert tck._wide_lib(name, False, tck.KV_GENERAL) is None
    # a meta tensor passes the op to the wrapper, which refuses the device
    before = dict(tck.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        tops.chai_decode_attention(q, k, k, h2c,
                                   torch.empty(2, dtype=torch.int32, **META),
                                   reps_per_group=2, ts=16)
    assert tck.LAUNCHES == before


@pytest.mark.parametrize("hd,ok", [(320, True), (256, True), (324, False),
                                   (328, False)])
def test_flash_wrappers_take_hd320(hd, ok):
    """The flash decode pair: a multiple of 8 up to 320 (the wide instance
    above 256, whose block takes 320 query columns a head)."""
    q = torch.empty(2, 8, hd, dtype=torch.bfloat16, **META)
    k = torch.empty(2, 4, 64, hd, dtype=torch.bfloat16, **META)
    pool = torch.empty(9, 4, 16, hd, dtype=torch.bfloat16, **META)
    bt = torch.empty(2, 4, dtype=torch.int32, **META)
    pos = torch.empty(2, dtype=torch.int32, **META)
    before = dict(tfk.LAUNCHES)
    for call in (lambda: tfk.flash_decode(q, k, k, pos, ts=16),
                 lambda: tfk.paged_decode(q, pool, bt, bt, pos)):
        with pytest.raises(ValueError, match="CUDA" if ok else "multiple"):
            call()
    assert tfk.LAUNCHES == before
    if ok:
        cfg, _ = tfk.dense_decode_config(q, k, ts=16)
        assert cfg == tfk.paged_decode_config(q, pool, bt)
        kh = cfg.heads_per_block
        width = 320 if hd > 256 else 256
        assert cfg.smem_bytes == 4 * (kh * width + kh * 64 + kh * 128 * 8
                                      + kh * 64 + 3 * kh) + 4
        assert cfg.smem_bytes <= 48 * 1024
