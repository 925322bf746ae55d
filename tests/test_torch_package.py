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
        assert "repro_torch.gateway.handlers" in names
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
    assert int(r.stdout.split()[-1]) >= 76     # every module was walked


def test_no_source_imports_jax_or_repro():
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted(PKG.rglob("*.py"))
    assert files
    for f in files:
        assert not bad.search(f.read_text()), f


ROOT = SRC.parent
#: the port's scripts that drive it on the card
CARD_SCRIPTS = ["chip_smoke.py"] + sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "benchmarks").glob("*_phases.py"))


@pytest.mark.parametrize("script", CARD_SCRIPTS)
def test_card_scripts_import_no_jax_or_repro(script):
    """``chip_smoke.py`` and the ``benchmarks/*_phases.py`` that run its
    phases import neither JAX nor the JAX package: no such import line,
    and the script imports with both unimportable."""
    bad = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    assert not bad.search((ROOT / script).read_text())
    code = textwrap.dedent(f"""
        import importlib.util, os, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        os.chdir({str(ROOT)!r})
        sys.path.insert(0, {str(ROOT)!r})
        spec = importlib.util.spec_from_file_location(
            "card_script", {str(ROOT / script)!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        assert not any(k == "jax" or k.startswith(("jax.", "repro."))
                       for k, v in sys.modules.items() if v is not None)
        print("IMPORTED")
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0 and "IMPORTED" in r.stdout, r.stderr[-3000:]


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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_params(cfg)
    assert model.abstract_params(cfg)["embed"].device.type == "meta"
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
    from repro_torch.core.controller import ClusterController
    from repro_torch.core.daemon import ClusterDaemon
    from repro_torch.core.topology import Topology
    topo = Topology(n_pods=1, pod_x=1, pod_y=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterController(topo)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ClusterDaemon(topo)


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


def _ctypes_for(kind):
    """The ctypes type a C argument of this kind must be bound as."""
    import ctypes
    return {"pointer": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float, "long long": ctypes.c_longlong}.get(kind)


def _c_prototypes():
    """Every ``extern "C" <ret> <name>(<args>)`` in ``csrc/*.cu`` as
    {name: [argument kind, ...]}, a kind being ``pointer`` or a C type."""
    from repro_torch.kernels import _build
    proto = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(([^)]*)\)',
                       re.S)
    out = {}
    for src in _build.sources():
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, args in proto.findall(text):
            kinds = []
            for arg in args.split(","):
                words = arg.replace("*", " * ").split()
                if "*" in words:
                    kinds.append("pointer")
                else:
                    kinds.append(" ".join(w for w in words[:-1]
                                          if w != "const"))
            out[name] = kinds
    return out


def test_every_ctypes_signature_matches_its_c_prototype():
    """A ctypes ``argtypes`` list that disagrees with the C function
    silently truncates pointers or shifts arguments: each entry of
    ``_build.SIGNATURES`` (and ``cuda_error_string``) has the C
    prototype's argument count, and each argument the ctypes type of its
    kind (pointer -> c_void_p, int -> c_int, float -> c_float, long long
    -> c_longlong)."""
    import ctypes
    from repro_torch.kernels import _build
    protos = _c_prototypes()
    sigs = dict(_build.SIGNATURES, cuda_error_string=[ctypes.c_int])
    for name, argtypes in sigs.items():
        assert name in protos, f"no extern \"C\" prototype for {name}"
        kinds = protos[name]
        assert len(kinds) == len(argtypes), (name, kinds, argtypes)
        for i, (kind, ct) in enumerate(zip(kinds, argtypes)):
            want = _ctypes_for(kind)
            assert want is not None, f"{name} arg {i}: C type {kind!r}"
            assert ct is want, (name, i, kind, ct)


#: files the port has and the JAX package has not: the device and interop
#: helpers, the CUDA build and sources, the daemon's service mode across
#: ranks (one JAX process needs none), and the ``__init__.py`` of the seven
#: packages that the JAX package keeps as namespace packages
PORT_ONLY = {"device.py", "interop.py", "kernels/_build.py", "__init__.py",
             # the sLSTM recurrence's and the mLSTM chunked scan's
             # kernels: the reference's are lax.scans inside
             # models/ssm.py and kernels/ops.py, not kernel modules; the
             # dense decode attention's: the reference's is plain jnp in
             # kernels/ops.py
             "kernels/slstm.py", "kernels/mlstm.py",
             "kernels/decode_attention.py",
             "core/service.py",
             "checkpoint/__init__.py", "data/__init__.py",
             "launch/__init__.py", "models/__init__.py", "serve/__init__.py",
             "sharding/__init__.py", "train/__init__.py"}


def test_every_module_has_its_reference_counterpart():
    """The port mirrors the JAX package's layout file for file: each module
    under ``src/repro_torch/`` sits at the same relative path under
    ``src/repro/``, but for the listed port-only files.  Paths only,
    nothing imported."""
    ref = SRC / "repro"
    mods = sorted(p.relative_to(PKG).as_posix() for p in PKG.rglob("*.py"))
    assert "train/quantized_state.py" in mods
    assert all((PKG / p).exists() for p in PORT_ONLY)
    stray = [p for p in mods
             if p not in PORT_ONLY and not (ref / p).is_file()]
    assert not stray, f"port modules without a reference counterpart: {stray}"
    assert (PKG / "kernels" / "csrc").is_dir()


#: the port's copies of reference modules that need no JAX: each is the
#: reference file with ``repro`` read as ``repro_torch``, nothing else
VERBATIM = (
    ["models/config.py", "obs/trace.py", "obs/metrics.py", "obs/flight.py",
     "obs/bridge.py", "obs/__init__.py", "core/__init__.py"]
    + [f"core/{m}.py" for m in ("block", "topology", "inflight", "events",
                                "registry", "policy", "partition",
                                "interference", "monitor", "scheduler",
                                "daemon")]
    + [f"configs/{c}.py" for c in ("deepseek_7b", "mistral_nemo_12b",
                                   "starcoder2_15b", "yi_34b",
                                   "zamba2_2p7b", "pixtral_12b",
                                   "hubert_xlarge", "deepseek_v2_236b",
                                   "llama4_maverick_400b", "xlstm_350m")]
    + [f"analysis/{m}" for m in ("__init__.py", "__main__.py",
                                 "_astutil.py", "events_check.py",
                                 "lifecycle.py", "locks.py", "report.py",
                                 "rules.py", "run.py", "runtime_check.py",
                                 "baseline.json")]
    + [f"federation/{m}.py" for m in ("__init__", "health", "partition",
                                      "placer", "pods")]
    + [f"engine/{m}.py" for m in ("__init__", "autostep", "pacing")]
    + [f"gateway/{m}.py" for m in ("__init__", "auth", "profiles",
                                   "ratelimit", "server")]
    + [f"launch/{m}.py" for m in ("hlo_parse", "attribute")])


@pytest.mark.parametrize("path", VERBATIM)
def test_verbatim_copy_equals_its_reference(path):
    """A copied module is its reference once ``repro_torch`` is read as
    ``repro``: the copy re-points its imports (and the paths that name
    the package) and changes nothing else."""
    got = (PKG / path).read_text().replace("repro_torch", "repro")
    assert got == (SRC / "repro" / path).read_text(), path


#: the dashboard's assets, copied byte for byte
STATIC = ("index.html", "app.js", "style.css")


@pytest.mark.parametrize("name", STATIC)
def test_dashboard_asset_equals_its_reference(name):
    """The gateway serves the reference's dashboard unchanged: each asset
    under ``gateway/static/`` is the reference's, byte for byte, and the
    port's static directory holds no other file."""
    got = PKG / "gateway" / "static" / name
    assert got.read_bytes() == (SRC / "repro" / "gateway" / "static"
                                / name).read_bytes()
    assert sorted(p.name for p in got.parent.iterdir()) == sorted(STATIC)


def test_every_copied_reference_module_is_held():
    """Every port file that is its reference under the renaming is in
    ``VERBATIM``, so no copy goes unheld."""
    same = sorted(
        p.relative_to(PKG).as_posix() for p in PKG.rglob("*")
        if p.suffix in (".py", ".json")
        and (SRC / "repro" / p.relative_to(PKG)).is_file()
        and p.read_text().replace("repro_torch", "repro")
        == (SRC / "repro" / p.relative_to(PKG)).read_text())
    assert same == sorted(VERBATIM)
