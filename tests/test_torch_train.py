"""The port's train block against the JAX package's, on the CPU: quantized
optimizer state, the optimizer, ``loss_fn``, the train step over 6 steps,
the train ``BlockRuntime`` and the launcher, and the optimizer-state
interop.  Both packages start from the same params (moved across with
``interop``) and the same numpy batches; the JAX runs are the reference.

Tolerances, each with its reason:
* quantized state: bit for bit (the same fp32 ops, each rounded once);
* ``loss_fn``: fp32 ``atol=1e-5, rtol=1e-4`` on the value and on every
  grad leaf (XLA:CPU and ATen sum matmuls in different orders);
* the 6-step trajectories: losses at ``rtol=1e-4``; params at
  ``atol=2e-5, rtol=1e-4`` with fp32 moments and ``atol=2e-3`` with int8
  moments.  With int8 moments a last-bit difference in a gradient can move
  a moment across a code boundary, and the update of that element jumps;
  the trajectories therefore run with Adam's eps at 1e-3, which bounds how
  far an element whose v rounds to code 0 moves (at the default 1e-8 it
  moves by lr * m / 1e-8 in both frameworks, and which element does so
  depends on the last bit).  The largest param difference measured was
  2.6e-4 (int8) and 6e-7 (fp32).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.block import BlockGrant as JGrant  # noqa: E402
from repro.core.runtime import BlockRuntime as JRuntime  # noqa: E402
from repro.core.runtime import JobSpec as JJob  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import AttentionConfig as JAttn  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import quantized_state as jqs  # noqa: E402
from repro.train import train_step as jtrain  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.block import BlockGrant  # noqa: E402
from repro_torch.core.runtime import BlockRuntime, JobSpec  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.train import quantized_state as qs  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.config import (AttentionConfig, ModelConfig,  # noqa: E402
                                       ShapeConfig)
from repro_torch.models.transformer import flatten  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as train  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

F32_TOL = dict(atol=1e-5, rtol=1e-4)
TINY = dict(name="train_t", family="dense", n_layers=2, d_model=32,
            vocab_size=64, d_ff=64, param_dtype="float32")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    """The tiny fp32 GQA config of tests/test_serve.py in both packages,
    with JAX's params and the port's copy of them."""
    jcfg = JModelConfig(**TINY, attention=JAttn(n_heads=4, n_kv_heads=2,
                                                head_dim=8))
    cfg = ModelConfig(**TINY, attention=AttentionConfig(n_heads=4,
                                                        n_kv_heads=2,
                                                        head_dim=8))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, cfg, jp


def port_params(jp):
    return interop.params_from_numpy(np_tree(jp), "cpu")


# ======================================================= quantized state

def assert_bits(got, want):
    w = np.asarray(want)
    g = got.numpy()
    assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape)
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["scalar", "ragged_300", "multidim",
                                  "zeros", "half_codes"])
def test_quantize_dequantize_bit_exact_vs_jax(case):
    rng = np.random.default_rng(11)
    x = {"scalar": np.float32(0.37),
         "ragged_300": rng.standard_normal(300, dtype=np.float32),
         "multidim": rng.standard_normal((3, 5, 300), dtype=np.float32),
         "zeros": np.zeros((3, 700), np.float32),
         # exact halves of a code step: rounding is half to even
         "half_codes": (np.arange(-8, 9, dtype=np.float32) + 0.5) * 2.0
         }[case]
    x = np.asarray(x)
    want = jqs.quantize(jnp.asarray(x))
    got = qs.quantize(torch.from_numpy(np.array(x)))
    assert_bits(got["q"], want["q"])
    assert_bits(got["s"], want["s"])
    assert_bits(qs.dequantize(got), jqs.dequantize(want))
    if case == "zeros":
        assert torch.all(got["s"] == 1.0)


@pytest.mark.parametrize("shape", [(), (5,), (300,), (2, 3, 513)])
def test_zeros_like_quantized_vs_jax(shape):
    want = jqs.zeros_like_quantized(jnp.zeros(shape, jnp.bfloat16))
    got = qs.zeros_like_quantized(torch.zeros(shape, dtype=torch.bfloat16))
    assert_bits(got["q"], want["q"])
    assert_bits(got["s"], want["s"])


# ============================================================ optimizer

def test_schedule_vs_jax():
    cfg = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    jcfg = jopt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
    steps = np.arange(0, 120, 7, dtype=np.int32)
    got = opt.schedule(cfg, torch.from_numpy(steps))
    want = jopt.schedule(jcfg, jnp.asarray(steps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("fused", ["off", "auto"])
def test_optimizer_apply_vs_jax(bits, fused):
    """Three ``apply`` steps with the same numpy grads: stacked, ragged,
    1-d and scalar leaves, weight decay on the ndim >= 2 ones.  The
    schedule's cos and pow may differ by an fp32 ulp between XLA and ATen,
    so params and fp32 moments are held at rtol 1e-5 and int8 codes may
    differ by 1 on at most 1% of the elements."""
    rng = np.random.default_rng(12)
    shapes = {"stack": (3, 4, 300), "w": (8, 300), "b": (257,), "t": ()}
    params = {k: rng.standard_normal(s, dtype=np.float32)
              for k, s in shapes.items()}
    kw = dict(state_bits=bits, fused=fused, warmup_steps=0, lr=1e-2)
    jcfg, cfg = jopt.OptConfig(**kw), opt.OptConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    js, ts = jopt.init(jp, jcfg), opt.init(tp, cfg)
    for i in range(3):
        grads = {k: rng.standard_normal(s, dtype=np.float32) * (i + 1)
                 for k, s in shapes.items()}
        jp, js, jm = jopt.apply(jcfg, jp, js,
                                {k: jnp.asarray(v) for k, v in grads.items()})
        tp2, ts2, tm = opt.apply(cfg, tp, ts,
                                 {k: torch.from_numpy(np.array(v))
                                  for k, v in grads.items()})
        assert tp2 is tp and ts2 is ts        # updated in place
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
        for mom in ("m", "v"):
            got, want = ts[mom][k], js[mom][k]
            if bits == 8:
                dq = np.abs(got["q"].numpy().astype(int)
                            - np.asarray(want["q"]).astype(int))
                assert dq.max() <= 1 and dq.mean() <= 0.01, k
                np.testing.assert_allclose(got["s"].numpy(),
                                           np.asarray(want["s"]), rtol=1e-5)
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-9)


def test_global_norm_vs_jax():
    rng = np.random.default_rng(13)
    tree = {"a": rng.standard_normal((4, 5), dtype=np.float32),
            "b": {"c": rng.standard_normal(7, dtype=np.float32)}}
    got = opt.global_norm(interop.params_from_numpy(tree, "cpu"))
    want = jopt.global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ============================================================== loss_fn

def tiny_batch(cfg, seed=5, batch=2, seq=12):
    return pipeline.synthetic_batch(cfg, ShapeConfig("t", "train", seq,
                                                     batch), step=0,
                                    seed=seed)


def test_loss_fn_value_and_grads_vs_jax(tiny):
    jcfg, cfg, jp = tiny
    nb = tiny_batch(cfg)

    def jloss(p):
        return jmodel.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in nb.items()})[0]

    want_l, want_g = jax.value_and_grad(jloss)(jp)
    state = train.make_train_state(cfg, 0, opt.OptConfig(),
                                   params=port_params(jp), device="cpu")
    got_l, got_g = train.value_and_grad(
        state["params"], cfg, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(got_l), float(want_l), **F32_TOL)
    want_flat = dict(flatten(jax.tree.map(np.asarray, want_g)))
    got_flat = dict(flatten(got_g))
    assert set(got_flat) == set(want_flat)
    for path, g in got_flat.items():
        np.testing.assert_allclose(g.numpy(), want_flat[path], err_msg=path,
                                   **F32_TOL)
    # the eval step is the same loss without gradients
    ev = train.make_eval_step(cfg)(state["params"],
                                   {k: torch.from_numpy(v)
                                    for k, v in nb.items()})
    assert float(ev["loss"]) == float(got_l) and not ev["loss"].requires_grad


def test_remat_and_plain_forward_give_the_same_grads(tiny):
    """``remat="full"`` recomputes each group in the backward; the grads
    are those of the plain forward, bit for bit."""
    jcfg, cfg, jp = tiny
    nb = {k: torch.from_numpy(v) for k, v in tiny_batch(cfg).items()}
    out = []
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        st = train.make_train_state(c, 0, opt.OptConfig(),
                                    params=port_params(jp), device="cpu")
        out.append(train.value_and_grad(st["params"], c, nb))
    assert float(out[0][0]) == float(out[1][0])
    for (p, a), (_, b) in zip(flatten(out[0][1]), flatten(out[1][1])):
        assert torch.equal(a, b), p


# ======================================================= the train step

@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_six_steps_vs_jax(tiny, bits, microbatch):
    """6 steps of ``make_train_step`` from identical params and optimizer
    state on the same ``DataIterator`` batches: losses and grad norms at
    rtol 1e-4, the final params within the module docstring's
    tolerance."""
    jcfg, cfg, jp = tiny
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, eps=1e-3,
              state_bits=bits)
    jo, o = jopt.OptConfig(**kw), opt.OptConfig(**kw)
    jshape = JShape("t", "train", seq_len=16, global_batch=4,
                    microbatch=microbatch)
    shape = ShapeConfig("t", "train", seq_len=16, global_batch=4,
                        microbatch=microbatch)
    jstate = {"params": jp, "opt": jopt.init(jp, jo)}
    state = train.make_train_state(cfg, 0, o, params=port_params(jp),
                                   device="cpu")
    state["opt"] = interop.opt_state_from_numpy(np_tree(jstate["opt"]),
                                                 "cpu")
    jstep = jax.jit(jtrain.make_train_step(jcfg, jshape, jo))
    step = train.make_train_step(cfg, shape, o)
    jdata = jpipeline.DataIterator(jcfg, jshape, seed=1)
    data = pipeline.DataIterator(cfg, shape, seed=1, device="cpu")
    want, got = [], []
    for i in range(6):
        b = data.batch(i)
        jb = jdata.batch(i)
        for k in jb:
            assert np.array_equal(b[k].numpy(), np.asarray(jb[k]))
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4)
    tol = dict(atol=2e-3) if bits == 8 else dict(atol=2e-5, rtol=1e-4)
    want_p = dict(flatten(np_tree(jstate["params"])))
    for path, leaf in flatten(state["params"]):
        np.testing.assert_allclose(leaf.detach().numpy(), want_p[path],
                                   err_msg=path, **tol)
    assert int(state["opt"]["step"]) == 6


def test_train_step_mixed_accum_and_overlap_comm(tiny):
    jcfg, cfg, jp = tiny
    p = torch.zeros(1 << 22)
    assert train.accum_dtype("mixed", p) == torch.bfloat16
    assert train.accum_dtype("f32", p) == torch.float32
    assert train.accum_dtype("mixed", p[:10]) == torch.float32
    shape = ShapeConfig("t", "train", seq_len=8, global_batch=2,
                        microbatch=2)
    # the compressed cross-pod reduce needs a mesh with a pod axis, an
    # assertion as in the reference's
    # ``test_train_step_overlap_comm_requires_pod_axis``
    with pytest.raises(AssertionError):
        train.make_train_step(cfg, shape, opt.OptConfig(), overlap_comm=True)


# ========================================================= the runtime

def test_train_runtime_matches_jax(tiny, tmp_path):
    """``BlockRuntime(kind="train")``: ``step`` and the in-flight window
    with ``collect_metrics`` give the JAX block's losses, step for step,
    and after the port's block is suspended and resumed its next step
    still gives the JAX block's."""
    jcfg, cfg, jp = tiny
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    shape_kw = dict(seq_len=16, global_batch=2)
    jjob = JJob(jcfg, JShape("t", "train", **shape_kw), kind="train",
                opt=jopt.OptConfig(**kw), seed=2, collect_metrics=True)
    job = JobSpec(cfg, ShapeConfig("t", "train", **shape_kw), kind="train",
                  opt=opt.OptConfig(**kw), seed=2, collect_metrics=True)
    jrt = JRuntime(JGrant.new([(0, 0, 0)], (1, 1), 60.0), jjob,
                   [jax.devices()[0]], str(tmp_path / "ckpt"))
    jrt.init_state()
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), job,
                      devices=["cpu"], ckpt_root=str(tmp_path / "port"))
    st = np_tree(jrt.state)
    rt.init_state(params=port_params(st["params"]),
                  opt_state=interop.opt_state_from_numpy(st["opt"], "cpu"))
    for _ in range(2):
        want, got = jrt.step(), rt.step()
        assert got["step_s"] >= 0
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    for r in (jrt, rt):
        r.dispatch()
        r.dispatch()
    want, got = jrt.drain(), rt.drain()
    assert len(got) == len(want) == 2 and rt.inflight_depth == 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        assert g["step_s"] >= 0
    assert rt.step_count == jrt.step_count == 4
    rt.save()
    assert rt.suspend() == {"step": 4, "drained_steps": 0}
    assert rt.resume(rt.grant, ["cpu"]) == 4 and rt.ckpt.steps() == [4]
    want, got = jrt.step(), rt.step()
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


def test_launcher_main_on_cpu(capsys):
    rc = launch_train.main(["--arch", "deepseek_7b", "--smoke", "--device",
                            "cpu", "--steps", "3", "--seq-len", "16",
                            "--global-batch", "4", "--microbatch", "2",
                            "--log-every", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.count("step ") == 3 and "# done:" in out and "tok/s" in out
    loss = float(out.split("step     0 loss")[1].split()[0])
    assert np.isfinite(loss) and 0 < loss < 10


# ============================================================== interop

@pytest.mark.parametrize("bits", [None, 8])
def test_opt_state_interop_round_trip(tiny, bits):
    """JAX's optimizer state -> the port -> numpy is bit-exact leaf for
    leaf, with the tree paths JAX flattens to."""
    jcfg, cfg, jp = tiny
    jo = jopt.OptConfig(state_bits=bits)
    grads = jax.tree.map(lambda x: jnp.ones_like(x) * 0.3, jp)
    _, js, _ = jopt.apply(jo, jp, jopt.init(jp, jo), grads)
    js = np_tree(js)
    back = interop.opt_state_to_numpy(interop.opt_state_from_numpy(js,
                                                                   "cpu"))
    a = jax.tree_util.tree_flatten_with_path(js)[0]
    b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert np.array_equal(np.asarray(x).reshape(-1).view(np.uint8),
                              np.asarray(y).reshape(-1).view(np.uint8))


# ============================================================ chip_smoke

def test_chip_smoke_train_phases_rehearse_on_cpu(capsys):
    """chip_smoke.py's train phases at smoke size on the CPU, the hybrid's
    (``train_hybrid``: step 0 in fp32 with the weights upcast, and in
    bf16) among them: the plain versions run (no kernel launches), the
    step-0 checks against ``impl="torch"`` are exact, the bf16 step 0's
    distance from the fp32 one is the plain version's, and the losses are
    finite.  The ``preempt`` phase's three sub-runs continue across a
    suspend as their uninterrupted runs do (its train sub-run's losses
    are train_hybrid's).  The launches the card is held to per step
    (``train_launches``): the dense train phase's (30 layers) and
    train_f32's (4 layers, 2 microbatches) as read on the card, and in a
    full-width hybrid step 90 SSD scans (forward and remat), 45 SSD
    backward, 18 and 9 flash attention, 217 and 109 RMSNorm, one fp32
    AdamW launch for each of the 19 leaves; in a full-size hubert_xlarge
    step 96 and 48 flash attention, no RMSNorm, and 15 fp32 AdamW
    launches, the 504-wide LM head's on the scalar route."""
    import repro_torch.configs as configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import OptConfig
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    exact = ("loss_rel_err", "grad_norm_rel_err",
             "worst_leaf_grad_norm_rel_err", "leaf_rms_rel_err")
    for phase in (smoke.phase_train, smoke.phase_train_f32,
                  smoke.phase_train_hybrid):
        out = phase(device="cpu", smoke=True)
        checks = out["step0_check"]
        for chk in ([checks["f32"], checks["bf16"]] if "f32" in checks
                    else [checks]):
            assert all(chk[k] == 0.0 for k in exact)
            assert chk["finite"]
        assert len(out["losses"]) == out["steps"] >= 2
        assert all(np.isfinite(out["losses"]))
        assert set(out["launches"].values()) == {0}
    assert out["arch"] == "zamba2_2p7b_smoke"
    assert checks["f32"]["within_rtol"] and checks["bf16_vs_f32"][
        "within_rtol"]
    pre = smoke.phase_preempt(device="cpu", smoke=True)
    train = pre["train_hybrid"]
    assert train["losses"] == train["uninterrupted_losses"] == out["losses"]
    assert pre["serve_paged"]["emissions_equal"]
    assert pre["serve_paged"]["running"] and pre["serve_paged"]["queued"]
    assert pre["serve_hybrid"]["checkpoints_kept"] == [4]
    assert pre["serve_hybrid"]["async_save"]["progress_lost_after"] == 0
    for sub in ("train_hybrid", "serve_paged", "serve_hybrid"):
        assert pre[sub]["progress_lost_before_save"] > 0
        assert pre[sub]["progress_lost_after_save"] == 0
        assert pre[sub]["leaves_bitwise_equal"] > 0
    assert set(pre["launches"].values()) == {0}
    for k in exact:
        assert checks["bf16_vs_f32"][k] == checks["bf16_plain_vs_f32"][k]

    def launches(arch, layers, microbatch, bits):
        cfg = dataclasses.replace(configs.get(arch), **(
            {"n_layers": layers} if layers else {}))
        # the phase's own leaves: their last dims choose each AdamW
        # launch's route
        leaves = dict(flatten(init_params(cfg, device="meta")))
        shape = ShapeConfig("chip", "train", seq_len=2048, global_batch=2,
                            microbatch=microbatch)
        want = smoke.train_launches(cfg, shape, OptConfig(state_bits=bits),
                                    leaves)
        assert set(want) == set(smoke.COUNTERS)
        return {k: v for k, v in want.items() if v}

    assert launches("deepseek_7b", 0, 1, 8) == {
        "flash_attention": 60, "flash_attention_bwd": 30, "rmsnorm": 121,
        "rmsnorm_bwd": 61, "fused_adamw_i8": 12}
    assert launches("deepseek_7b", 4, 2, None) == {
        "flash_attention": 16, "flash_attention_bwd": 8, "rmsnorm": 34,
        "rmsnorm_bwd": 18, "fused_adamw_f32": 12}
    assert launches("zamba2_2p7b", 0, 1, None) == {
        "ssd_scan": 90, "ssd_scan_bwd": 45, "flash_attention": 18,
        "flash_attention_bwd": 9, "rmsnorm": 217, "rmsnorm_bwd": 109,
        "fused_adamw_f32": 19}
    assert launches("hubert_xlarge", 0, 1, None) == {
        "flash_attention": 96, "flash_attention_bwd": 48,
        "fused_adamw_f32": 15, "fused_adamw_scalar": 1}
    assert smoke.KERNEL_META["ssd_scan_bwd"]["replaces"] == \
        "src/repro/kernels/ops.py:319"
    assert '"ok": true' not in capsys.readouterr().out


def test_chip_smoke_train_sharded_rehearses_on_cpu():
    """chip_smoke.py's ``train_sharded`` at smoke size on the CPU, under a
    one-rank gloo group it starts and destroys: ``train``'s job on a
    (1, 1) DeviceMesh, every param a DTensor, its losses, grad norms and
    state checksums bit for bit ``train``'s, the checkpoint round trip
    bit for bit, and no process group left behind."""
    import torch.distributed as dist
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    train = smoke.phase_train(device="cpu", smoke=True)
    out = smoke.phase_train_sharded(device="cpu", smoke=True, train=train)
    assert not dist.is_initialized()
    assert out["mesh"] == [1, 1] and out["backend"] == "gloo"
    assert out["losses"] == train["losses"] and len(out["losses"]) == 2
    assert out["grad_norms"] == train["grad_norms"]
    assert out["state_checksums"] == train["state_checksums"]
    assert out["losses_equal_train"] and out["state_checksums_equal_train"]
    assert out["restore_bitwise_equal"] and out["ckpt_gb"] > 0
    assert set(out["launches"].values()) == {0}
