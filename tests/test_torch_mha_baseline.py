"""The MHA baseline (``EngineConfig(use_chai=False)``) against the JAX
package's, on the CPU.

Without CHAI the decode state carries no WARMUP score buffer, and the
port's plain decode attention is the flash decode op: ``kernels.ops.
paged_decode_attention`` over the paged pool in place (the continuous
engine's default layout), ``flash_decode_attention`` over the dense
cache (the continuous engine's dense layout and the cohort engine), whose
CUDA kernels replace the reference's Pallas ``paged_decode`` /
``flash_decode``. The reference's engines decode the same function in
jnp.

Reduced chai-llama-7b (MHA, 2 layers, d=64, 8 heads) and reduced
nemotron-4-15b (GQA, 2 layers, 12 heads over 2 KV groups, d=96), fp32,
the reference's own ``init_params`` weights through ``params_from_numpy``:
each of the port's engines (continuous paged, continuous dense, cohort)
serves 4 requests on 2 slots, and its greedy tokens equal the reference
engine's of the same kind; every decode step of every layer went through
the op of its layout (counted), never through the eager attention that
CHAI WARMUP keeps (``_decode_attention_batched``, counted too).
"""
import numpy as np
import pytest

import jax

from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.models import transformer as jtfm
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import ops as tops
from repro_torch.models import transformer as ttfm
from repro_torch.serving.engine import EngineConfig, ServingEngine
from repro_torch.weights import params_from_numpy

CONFIGS = {"chai-llama-7b": {},
           "nemotron-4-15b": dict(n_heads=12, d_model=96)}
ENGINES = {"paged": dict(kv_layout="paged"), "dense": dict(kv_layout="dense"),
           "cohort": dict(scheduler="cohort")}
PROMPT_LENS = (11, 6, 17, 9)
BUDGETS = (8, 5, 7, 3)


@pytest.fixture(scope="module", params=list(CONFIGS))
def models(request):
    kw = CONFIGS[request.param]
    jcfg = jreduced(jget_config(request.param), n_layers=2, **kw)
    tcfg = reduced(get_config(request.param), n_layers=2, **kw)
    jparams = jtfm.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, tcfg, jparams, tparams


def _ecfg(cls, engine):
    return cls(batch_slots=2, max_seq=64, page_size=16, use_chai=False,
               **ENGINES[engine])


def _serve(eng, vocab):
    rng = np.random.default_rng(0)
    for i, (n, m) in enumerate(zip(PROMPT_LENS, BUDGETS)):
        eng.submit(rng.integers(0, vocab, size=n), max_new_tokens=m, uid=i)
    return {r.uid: list(r.generated) for r in eng.run()}


class _CountingOps:
    """Stands in for ``kernels.ops`` inside ``models.transformer``: counts
    the decode ops' calls, then dispatches as the module would."""

    def __init__(self):
        self.calls = {"flash_decode_attention": 0,
                      "paged_decode_attention": 0}

    def __getattr__(self, name):
        return getattr(tops, name)

    def flash_decode_attention(self, *args, **kw):
        self.calls["flash_decode_attention"] += 1
        return tops.flash_decode_attention(*args, **kw)

    def paged_decode_attention(self, *args, **kw):
        self.calls["paged_decode_attention"] += 1
        return tops.paged_decode_attention(*args, **kw)


@pytest.mark.parametrize("engine", list(ENGINES))
def test_mha_baseline_tokens_match_reference(models, engine, monkeypatch):
    jcfg, tcfg, jparams, tparams = models
    want = _serve(JServingEngine(jcfg, jparams, _ecfg(JEngineConfig, engine)),
                  jcfg.vocab_size)
    counting = _CountingOps()
    eager = []
    batched = ttfm._decode_attention_batched
    monkeypatch.setattr(ttfm, "kops", counting)
    monkeypatch.setattr(ttfm, "_decode_attention_batched",
                        lambda *a: eager.append(1) or batched(*a))
    eng = ServingEngine(tcfg, tparams, _ecfg(EngineConfig, engine),
                        device="cpu")
    assert not eng.chai_on
    got = _serve(eng, tcfg.vocab_size)
    assert got == want
    assert [len(got[u]) for u in sorted(got)] == list(BUDGETS)
    own = ("paged_decode_attention" if engine == "paged"
           else "flash_decode_attention")
    assert counting.calls[own] == tcfg.n_layers * eng.steps_executed > 0
    assert sum(counting.calls.values()) == counting.calls[own]
    assert not eager
    if eng.paged:
        assert eng.dense_pool.pages_in_use == 0
