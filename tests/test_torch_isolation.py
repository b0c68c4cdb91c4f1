"""The port stands alone: no module of ``src/repro_torch/``, not
``chip_smoke.py`` and no measurement harness under ``tools/`` imports
jax, jaxlib, ml_dtypes or the reference package, and no entry point
silently runs on the CPU."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + sorted(
        (ROOT / "tools").glob("*.py"))


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "chip_smoke.py" in names
    assert "tools/qk_ab.py" in names
    for mod in ("chai_attention", "flash_attention"):
        assert f"src/repro_torch/kernels/{mod}.py" in names
    for mod in ("serving/api", "launch/api_stream",
                "launch/offline_clustering", "core/correlation",
                "core/elbow", "core/policy", "serving/faults",
                "serving/invariants", "serving/soak",
                "serving/telemetry", "serving/exporters",
                "serving/kv_tiers", "serving/async_api",
                "launch/serve_http", "models/moe", "models/frontends",
                "models/rglru", "models/rwkv", "optim/adamw",
                "optim/compression", "data/pipeline",
                "checkpoint/checkpoint", "train/train_step",
                "train/trainer", "launch/train", "sharding/rules",
                "sharding/context", "sharding/local", "launch/mesh",
                "launch/inputs", "launch/roofline", "launch/dryrun",
                "serving/workload"):
        assert f"src/repro_torch/{mod}.py" in names
    assert "src/repro_torch/configs/nemotron_4_15b.py" in names
    for cfg in ("gemma3_4b", "deepseek_moe_16b", "qwen3_moe_30b_a3b",
                "internvl2_76b", "musicgen_large", "recurrentgemma_9b",
                "rwkv6_1_6b"):
        assert f"src/repro_torch/configs/{cfg}.py" in names
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    for name in ("chai_fused_decode.cu", "paged_chai_fused_decode.cu",
                 "chai_decode_tiles.cuh", "flash_prefill.cu",
                 "paged_prefix_attend.cu", "flash_tiles.cuh",
                 "relay_prefix_decode.cu", "chai_qk.cu", "row_softmax.cu",
                 "row_loads.cuh",
                 "chai_av.cu", "flash_decode.cu", "paged_decode.cu",
                 "decode_tiles.cuh"):
        assert (csrc / name).exists(), name


def test_every_kernel_source_is_built():
    """``build.KERNELS`` names every ``csrc/*.cu`` (so ``chip_smoke.py``
    builds and checks each), and each source exports its launcher."""
    from repro_torch.kernels import build
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    assert sorted(build.KERNELS) == sorted(p.stem
                                           for p in csrc.glob("*.cu"))
    for name in build.KERNELS:
        src = (csrc / f"{name}.cu").read_text()
        assert f'extern "C" int {name}_launch(' in src, name
        assert "cudaGetLastError()" in src, name
    for name, source in build.SOURCE_OF.items():
        assert source in build.KERNELS, name
        src = (csrc / f"{source}.cu").read_text()
        assert f'extern "C" int {name}_launch(' in src, name


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_refuse_a_missing_gpu(monkeypatch, tmp_path):
    """``device=None`` means CUDA; without a GPU every entry point raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import (api_stream, offline_clustering, serve,
                                    serve_http)
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.api import LLM
    from repro_torch.serving.async_api import AsyncLLM
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.weights import params_from_numpy
    cfg = reduced(get_config("chai-llama-7b"), n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for ecfg in (EngineConfig(), EngineConfig(scheduler="cohort")):
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingEngine(cfg, params, ecfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"embed": {"tok": [[0.0]]}})
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--reduced", "--requests", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        LLM(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        AsyncLLM(cfg, params)
    for main in (api_stream.main, offline_clustering.main, serve_http.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--reduced"])
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.launch import train
    from repro_torch.train.trainer import Trainer, TrainerConfig
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    data = DataConfig(vocab_size=16, seq_len=4, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, data, TrainerConfig(ckpt_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticPipeline(data).global_batch_tensor(0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore(1, {"a": torch.zeros(2)})
    from repro_torch.launch import mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_mesh((1, 1), ("data", "model"))


def test_mesh_names_the_world_it_needs():
    """No port call site waits for the sharding tooling any more; a mesh
    larger than the world raises naming the ranks it needs (no process
    group is made for it)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        assert "#16" not in path.read_text(), path
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs 4 ranks, have 1"):
        mesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks, have 1"):
            mesh.make_production_mesh(multi_pod=multi, device="cpu")
    assert not dist.is_initialized()


def test_continuous_scheduler_names_the_next_slice():
    """The default ``EngineConfig()`` is the continuous scheduler on the
    paged layout, and it runs, seeded sampling too; ``priority`` (#9,
    ported) and ``kv_offload`` (#13, ported) serve: no setting of the
    engine is refused any more."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.sampling import SamplingParams
    cfg = reduced(get_config("chai-llama-7b"), n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(cfg, params, EngineConfig(), device="cpu")
    assert eng.ecfg.scheduler == "continuous" and eng.paged
    eng.submit([1, 2, 3], max_new_tokens=2)
    eng.submit([1, 2, 3], max_new_tokens=2,
               sampling=SamplingParams(temperature=1.0, seed=4))
    assert [len(r.generated) for r in eng.run()] == [2, 2]
    hi = eng.add_request([1, 2, 3], max_new_tokens=2, priority=2)
    assert [r.uid for r in eng.run()][-1] == hi.uid
    assert hi.priority == 2 and len(hi.generated) == 2
    tiered = ServingEngine(cfg, params, EngineConfig(kv_offload=True),
                           device="cpu")
    assert tiered.tiers is not None
    tiered.submit([1, 2, 3], max_new_tokens=2)
    assert [len(r.generated) for r in tiered.run()] == [2]
