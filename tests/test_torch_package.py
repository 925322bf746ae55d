"""Package rules of the port: it imports neither JAX nor the JAX package,
its entry points do not run on the host unless asked to, and a missing
CUDA compiler is an error, not a fallback."""
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
PKG = SRC / "repro_torch"


def test_every_module_imports_without_jax_or_repro():
    code = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # make both unimportable
        sys.modules["repro"] = None
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print("IMPORTED", len(names))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 25     # every module was walked


def test_no_source_imports_jax_or_repro():
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert files
    for f in files:
        assert not bad.search(f.read_text()), f


def test_entry_points_default_to_cuda_and_refuse_the_host():
    """Without a card, the default device raises instead of quietly
    running the plain PyTorch path on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    import repro_torch.configs as configs
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime, JobSpec
    from repro_torch.launch import serve, train
    from repro_torch.models import model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serve.decode_scheduler import DecodeScheduler

    cfg = configs.get_smoke("deepseek_7b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.Transformer(cfg)
    job = JobSpec(cfg, ShapeConfig("s", "serve", 16, 1), kind="serve")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), job)
    params = model.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeScheduler(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "deepseek_7b", "--smoke"])
    train_job = JobSpec(cfg, ShapeConfig("s", "train", 16, 1), kind="train")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), train_job)
    from repro_torch.train import optimizer, train_step
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_step.make_train_state(cfg, 0, optimizer.OptConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "deepseek_7b", "--smoke", "--steps", "1"])
    from repro_torch.data import pipeline
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.DataIterator(cfg, ShapeConfig("s", "train", 16, 1))


def test_build_without_nvcc_raises(tmp_path):
    from repro_torch.kernels import _build
    missing = str(tmp_path / "no" / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(nvcc=missing)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load(nvcc=missing)
    assert _build._LIB is None


def test_every_kernel_source_is_built_and_bound():
    """Each wrapper's C entry point has a signature, and every ``.cu``
    file names the TPU kernel it replaces and what bounds it."""
    from repro_torch.kernels import _build
    srcs = {p.name for p in _build.sources()}
    kernels = ("rmsnorm.cu", "flash_attention.cu", "paged_attention.cu",
               "flash_attention_bwd.cu", "fused_adamw.cu", "ssd_scan.cu")
    assert set(kernels) <= srcs
    text = "".join(p.read_text() for p in _build.sources())
    for name in _build.SIGNATURES:
        assert f'extern "C" int {name}(' in text, name
    for name in ("rmsnorm_launch", "rmsnorm_bwd_launch",
                 "flash_attention_launch", "flash_attention_bwd_launch",
                 "paged_attention_launch", "fused_adamw_launch",
                 "ssd_scan_launch"):
        assert name in _build.SIGNATURES, name
    for src in kernels:
        head = (_build.CSRC / src).read_text()[:4000]
        assert ("Replaces the TPU kernel" in head
                or "Not a TPU kernel" in head), src
        assert "Bound on the H100" in head and "Design:" in head, src
