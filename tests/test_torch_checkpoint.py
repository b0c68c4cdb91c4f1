"""The port's checkpoints and trainer against the JAX package's, on the
CPU.

* ``CheckpointManager`` in the shape of the reference's substrate tests:
  round trip, keep-N and latest, a crashed save leaving no partial,
  a shape mismatch raising.
* The on-disk format crosses both ways bit for bit: a tree of fp32,
  bf16 and int32 leaves, and a whole trainer state (params, AdamW step
  and moments), written by the reference and restored by the port, and
  the reverse; both packages write the same manifest for the same tree.
* ``Trainer`` in the shape of the reference's trainer tests (loss
  decrease, bitwise resume, straggler hook), on a tiny fp32 model.
* Lockstep: the reference's trainer runs 5 steps and saves; the port's
  restores that checkpoint and runs 5 more. Its losses and final params
  match the reference's own steps 6-10 at ``LOCKSTEP_TOL``.
"""
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro.configs.base import get_config as jget_config
from repro.configs.base import reduced as jreduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.trainer import TrainerConfig as JTrainerConfig
from repro_torch.checkpoint.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config, reduced
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch import train as train_cli
from repro_torch.optim.adamw import AdamWState, tree_leaves
from repro_torch.train.trainer import Trainer, TrainerConfig

# Five AdamW steps from the same state on the same batches: fp32 rounding
# of the two packages' forward, backward and update (each ~1e-6 relative)
# compounds through the moments.
LOCKSTEP_TOL = dict(rtol=1e-5, atol=1e-6)
KW = dict(n_layers=2, d_model=32, n_heads=4, d_ff=64, vocab=128)


def _tiny():
    return reduced(get_config("chai-llama-7b"), **KW).replace(
        dtype="float32")


def _jtiny():
    return jreduced(jget_config("chai-llama-7b"), **KW).replace(
        dtype="float32")


def _data_cfg(vocab):
    return DataConfig(vocab_size=vocab, seq_len=32, global_batch=4)


def _tree(rng):
    return {"a": torch.from_numpy(rng.normal(size=(4, 3)).astype(
                np.float32)),
            "b": {"c": torch.arange(5, dtype=torch.int32),
                  "d": torch.from_numpy(rng.normal(size=(2,)).astype(
                      np.float32)).to(torch.bfloat16)}}


def _bits(x):
    """A leaf's raw bytes, whichever package made it."""
    if torch.is_tensor(x):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    return np.asarray(x).tobytes()


# ----------------------------------------------------------- the manager ----
def test_checkpoint_roundtrip(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree(rng)
    mgr.save(10, tree, extra={"data_batch": 10})
    target = {"a": torch.zeros(4, 3), "b": {
        "c": torch.zeros(5, dtype=torch.int32),
        "d": torch.zeros(2, dtype=torch.bfloat16)}}
    out, extra = mgr.restore(10, target, device="cpu")
    for a, b in zip(tree_leaves(tree), tree_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert extra == {"data_batch": 10}
    # a dtype cast on restore, as the reference's
    wide = {**target, "a": torch.zeros(4, 3, dtype=torch.float64)}
    out, _ = mgr.restore(10, wide, device="cpu")
    assert out["a"].dtype == torch.float64
    assert torch.equal(out["a"], tree["a"].double())


def test_checkpoint_keep_n_and_latest(tmp_path, rng):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree(rng)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_crash_leaves_no_partial(tmp_path, rng):
    """A tmp dir from a crashed save is invisible to discovery and GC'd;
    a save that raises midway leaves nothing behind."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree(rng)
    mgr.save(1, tree)
    os.makedirs(os.path.join(str(tmp_path), "2.tmp.crashed"))
    assert mgr.all_steps() == [1]
    mgr.save(3, tree)                       # triggers GC of stale tmp
    assert not any(".tmp." in n for n in os.listdir(str(tmp_path)))

    class Boom:
        shape = (1,)

        def __array__(self, *a, **k):
            raise OSError("disk gone")
    with pytest.raises(Exception):
        mgr.save(5, {"a": tree["a"], "z": Boom()})
    assert mgr.all_steps() == [1, 3]
    assert sorted(os.listdir(str(tmp_path))) == ["1", "3"]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        mgr.restore(1, {"a": torch.zeros(4)}, device="cpu")
    with pytest.raises(KeyError):
        mgr.restore(1, {"b": torch.zeros(3)}, device="cpu")
    with pytest.raises(ValueError, match="#16"):
        mgr.restore(1, {"a": torch.zeros(3)}, device="cpu", shardings={})


# -------------------------------------------------- the format, crossing ----
def test_reference_checkpoint_restores_in_port_and_back(tmp_path, rng):
    """fp32, bf16 and int32 leaves: written by the reference, read by the
    port bit for bit; written by the port, read by the reference bit for
    bit; and the two manifests are the same."""
    tree = _tree(rng)
    jtree = {"a": jnp.asarray(tree["a"].numpy()),
             "b": {"c": jnp.asarray(tree["b"]["c"].numpy()),
                   "d": jnp.asarray(tree["b"]["d"].float().numpy(),
                                    jnp.bfloat16)}}
    JManager(str(tmp_path / "j")).save(7, jtree, extra={"data_batch": 7})
    out, extra = CheckpointManager(str(tmp_path / "j")).restore(
        7, tree, device="cpu")
    assert extra == {"data_batch": 7}
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(out)):
        assert _bits(a) == _bits(b)
    assert out["b"]["d"].dtype == torch.bfloat16
    CheckpointManager(str(tmp_path / "t")).save(7, tree,
                                                extra={"data_batch": 7})
    back, _ = JManager(str(tmp_path / "t")).restore(
        7, jax.tree.map(jnp.zeros_like, jtree))
    for a, b in zip(tree_leaves(tree), jax.tree.leaves(back)):
        assert _bits(a) == _bits(b)
    assert back["b"]["d"].dtype == jnp.bfloat16
    manifests = [json.load(open(tmp_path / d / "7" / "manifest.json"))
                 for d in ("j", "t")]
    assert manifests[0] == manifests[1]
    assert sorted(os.listdir(tmp_path / "t" / "7")) == sorted(
        os.listdir(tmp_path / "j" / "7"))


def test_trainer_state_crosses_both_ways(tmp_path):
    """A whole trainer state (params, ``opt/step``, ``opt/m``,
    ``opt/v``): the reference's restores in the port's trainer state bit
    for bit, and the port's in the reference's."""
    jtr = JTrainer(_jtiny(), JDataConfig(vocab_size=128, seq_len=32,
                                         global_batch=4),
                   JTrainerConfig(ckpt_dir=str(tmp_path / "j")))
    jstate = jtr.init_state()
    jstate["opt"] = jstate["opt"]._replace(
        step=jnp.int32(3),
        m=jax.tree.map(lambda p: p * 0.5, jstate["params"]))
    jtr.ckpt.save(3, jstate)
    tr = Trainer(_tiny(), _data_cfg(128),
                 TrainerConfig(ckpt_dir=str(tmp_path / "t")), device="cpu")
    target = tr.init_state()
    got, _ = CheckpointManager(str(tmp_path / "j")).restore(3, target,
                                                            device="cpu")
    assert isinstance(got["opt"], AdamWState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 3
    want = jax.tree.leaves(jstate)
    assert len(want) == len(tree_leaves(got["params"])) * 3 + 1
    for a, b in zip(want, [got["opt"].step] + tree_leaves(got["opt"].m)
                    + tree_leaves(got["opt"].v)
                    + tree_leaves(got["params"])):
        assert _bits(a) == _bits(b)
    tr.ckpt.save(4, target)
    back, _ = JManager(str(tmp_path / "t")).restore(4, jstate)
    for a, b in zip([target["opt"].step] + tree_leaves(target["opt"].m)
                    + tree_leaves(target["opt"].v)
                    + tree_leaves(target["params"]), jax.tree.leaves(back)):
        assert _bits(a) == _bits(b)


# ------------------------------------------------------------ the trainer ----
def test_trainer_loss_decreases(tmp_path):
    cfg = _tiny()
    tcfg = TrainerConfig(total_steps=30, ckpt_every=100, log_every=100,
                         ckpt_dir=str(tmp_path))
    tr = Trainer(cfg, _data_cfg(cfg.vocab_size), tcfg, device="cpu")
    _, m0 = tr._one_step(tr.init_state(), tr.pipe.global_batch_tensor(
        0, "cpu"))
    state, metrics = tr.run()
    assert float(metrics["loss"]) < float(m0["loss"]) - 0.3
    assert int(state["opt"].step) == 30


def test_trainer_restart_resumes_exactly(tmp_path):
    """Train 20 straight vs 10 + restart + 10: the same final loss and
    params bit for bit (stateless-seeded data, checkpointed optimizer)."""
    cfg = _tiny()
    d = _data_cfg(cfg.vocab_size)
    t1 = Trainer(cfg, d, TrainerConfig(total_steps=20, ckpt_every=100,
                                       log_every=100,
                                       ckpt_dir=str(tmp_path / "a")),
                 device="cpu")
    s_straight, m_straight = t1.run()
    kw = dict(total_steps=20, ckpt_every=10, log_every=100,
              ckpt_dir=str(tmp_path / "b"))
    Trainer(cfg, d, TrainerConfig(**kw), device="cpu").run(max_steps=10)
    t3 = Trainer(cfg, d, TrainerConfig(**kw), device="cpu")
    s_resumed, m_resumed = t3.run()
    np.testing.assert_allclose(float(m_straight["loss"]),
                               float(m_resumed["loss"]), rtol=1e-5)
    for a, b in zip(tree_leaves(s_straight["params"]),
                    tree_leaves(s_resumed["params"])):
        assert torch.equal(a, b)


def test_trainer_straggler_hook_fires(tmp_path):
    """A step delayed by 1.5 s fires the hook (the reference's test
    delays 0.5 s; its jitted steps take milliseconds, the port's eager
    CPU steps up to a few hundred on a loaded host)."""
    cfg = _tiny()
    seen = []
    tr = Trainer(cfg, _data_cfg(cfg.vocab_size),
                 TrainerConfig(total_steps=8, ckpt_every=100, log_every=100,
                               ckpt_dir=str(tmp_path), straggler_factor=2.0),
                 step_delay_hook=lambda s: 1.5 if s == 5 else 0.0,
                 on_straggler=lambda s, dt: seen.append(s), device="cpu")
    tr.run()
    assert 5 in seen


def test_trainer_refuses_compress_pods(tmp_path):
    with pytest.raises(ValueError, match="#16"):
        Trainer(_tiny(), _data_cfg(128),
                TrainerConfig(ckpt_dir=str(tmp_path), compress_pods=True),
                device="cpu")


def _record(trainer, out):
    """Wrap the trainer's step to record each step's loss."""
    one = trainer._one_step

    def step(state, batch):
        state, metrics = one(state, batch)
        out.append(float(metrics["loss"]))
        return state, metrics
    trainer._one_step = step


def test_lockstep_from_reference_checkpoint(tmp_path):
    """The reference's trainer runs steps 1-5 and saves; the port's
    trainer restores that checkpoint and runs steps 6-10; a second
    reference trainer resumes the same checkpoint for steps 6-10. Losses
    and final params agree at ``LOCKSTEP_TOL``."""
    jcfg, cfg = _jtiny(), _tiny()
    kw = dict(total_steps=10, ckpt_every=5, log_every=100, keep=5)
    jd = JDataConfig(vocab_size=128, seq_len=32, global_batch=4)
    ck = str(tmp_path / "ck")
    JTrainer(jcfg, jd, JTrainerConfig(ckpt_dir=ck, **kw)).run(max_steps=5)
    jtr = JTrainer(jcfg, jd, JTrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                            **kw))
    os.makedirs(tmp_path / "j", exist_ok=True)
    os.symlink(os.path.join(ck, "5"), tmp_path / "j" / "5")
    jlosses, tlosses = [], []
    _record(jtr, jlosses)
    jstate, jm = jtr.run()
    tr = Trainer(cfg, _data_cfg(128), TrainerConfig(ckpt_dir=ck, **kw),
                 device="cpu")
    _record(tr, tlosses)
    tstate, tm = tr.run()
    assert len(tlosses) == len(jlosses) == 5
    np.testing.assert_allclose(tlosses, jlosses, **LOCKSTEP_TOL)
    assert int(tstate["opt"].step) == int(jstate["opt"].step) == 10
    for g, grp in jstate["params"].items():
        for n, want in grp.items():
            want = np.asarray(want)
            np.testing.assert_allclose(tstate["params"][g][n].numpy(), want,
                                       rtol=LOCKSTEP_TOL["rtol"],
                                       atol=1e-5 * np.abs(want).max())
    assert CheckpointManager(ck).latest_step() == 10


def test_train_cli_on_cpu(tmp_path, capsys):
    assert train_cli.main(["--device", "cpu", "--steps", "3", "--seq", "16",
                           "--batch", "2", "--ckpt-dir",
                           str(tmp_path)]) == 0
    assert "[train] done: loss=" in capsys.readouterr().out
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
