"""The port stands alone: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports jax, jaxlib or the reference package, and no
entry point silently runs on the CPU."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


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
    for mod in ("chai_attention", "flash_attention"):
        assert f"src/repro_torch/kernels/{mod}.py" in names
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    for name in ("chai_fused_decode.cu", "paged_chai_fused_decode.cu",
                 "chai_decode_tiles.cuh", "flash_prefill.cu",
                 "paged_prefix_attend.cu", "flash_tiles.cuh"):
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


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_entry_points_refuse_a_missing_gpu(monkeypatch):
    """``device=None`` means CUDA; without a GPU every entry point raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.launch import serve
    from repro_torch.models.transformer import init_params
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


def test_continuous_scheduler_names_the_next_slice():
    """The default ``EngineConfig()`` is the continuous scheduler on the
    paged layout, and it runs; the settings of later slices raise
    ``NotImplementedError`` naming their ROADMAP item."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.transformer import init_params
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.sampling import SamplingParams
    cfg = reduced(get_config("chai-llama-7b"), n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = ServingEngine(cfg, params, EngineConfig(), device="cpu")
    assert eng.ecfg.scheduler == "continuous" and eng.paged
    eng.submit([1, 2, 3], max_new_tokens=2)
    assert [len(r.generated) for r in eng.run()] == [2]
    for kw in (dict(sampling=SamplingParams(temperature=1.0)),
               dict(priority=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            eng.add_request([1, 2, 3], max_new_tokens=2, **kw)
