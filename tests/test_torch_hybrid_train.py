"""The hybrid family's training (zamba2: Mamba2 + a weight-shared attention
block) in the port against the JAX package's, on the CPU, at
``get_smoke("zamba2_2p7b")`` made fp32 on both sides: ``loss_fn``'s value
and every leaf's gradient, 6 steps of ``make_train_step``, the train
``BlockRuntime`` and the launcher.  Both packages start from the same
params (moved across with ``interop``) and the same numpy batches; the JAX
runs are the reference.  On the CPU the port's SSD scan is the plain
version under autograd; ``tests/test_torch_kernels.py`` holds the plain
backward (the kernel's yardstick on the card) against ``jax.vjp``.

Tolerances, as ``tests/test_torch_train.py``'s for the dense family, each
with its reason there: ``loss_fn`` fp32 ``atol=1e-5, rtol=1e-4``; the
trajectories' losses and grad norms ``rtol=1e-4``, their params
``atol=2e-5, rtol=1e-4`` with fp32 moments and ``atol=2e-3`` with int8
moments (Adam's eps at 1e-3).  Where the hybrid's trajectory is chaotic,
the reference against itself from params moved by one ulp parts as far
as the port does; ``test_hybrid_train_step_six_steps_vs_jax`` says how it
keeps its checks meaningful.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core.block import BlockGrant as JGrant  # noqa: E402
from repro.core.runtime import BlockRuntime as JRuntime  # noqa: E402
from repro.core.runtime import JobSpec as JJob  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jtrain  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.block import BlockGrant  # noqa: E402
from repro_torch.core.runtime import BlockRuntime, JobSpec  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.transformer import flatten  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as train  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

F32_TOL = dict(atol=1e-5, rtol=1e-4)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def hybrid():
    """zamba2's smoke config, fp32, in both packages, with JAX's params."""
    jcfg = jconfigs.get_smoke("zamba2_2p7b").replace(param_dtype="float32")
    cfg = configs.get_smoke("zamba2_2p7b").replace(param_dtype="float32")
    assert cfg.family == "hybrid" and cfg.remat != "none"
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, cfg, jp


def port_params(jp):
    return interop.params_from_numpy(np_tree(jp), "cpu")


def test_hybrid_loss_fn_value_and_grads_vs_jax(hybrid):
    """Every leaf's gradient: the Mamba2 leaves (``A_log`` through A =
    -exp(A_log), ``dt_bias`` through softplus, ``D``, ``conv_w``, ``w_in``,
    the gated ``norm``, ``w_out``), the shared block's and the embedding,
    through the checkpointed groups."""
    jcfg, cfg, jp = hybrid
    nb = pipeline.synthetic_batch(cfg, ShapeConfig("t", "train", 32, 2),
                                  step=0, seed=5)

    def jloss(p):
        return jmodel.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in nb.items()})[0]

    want_l, want_g = jax.value_and_grad(jloss)(jp)
    state = train.make_train_state(cfg, 0, opt.OptConfig(),
                                   params=port_params(jp), device="cpu")
    got_l, got_g = train.value_and_grad(
        state["params"], cfg, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(got_l), float(want_l), **F32_TOL)
    want_flat = dict(flatten(np_tree(want_g)))
    got_flat = dict(flatten(got_g))
    assert set(got_flat) == set(want_flat)
    for leaf in ("A_log", "dt_bias", "D", "conv_w", "w_in", "norm", "w_out"):
        assert f"layers/mamba/blk/{leaf}" in got_flat, leaf
    for path, g in got_flat.items():
        assert float(g.abs().max()) > 0, path
        np.testing.assert_allclose(g.numpy(), want_flat[path], err_msg=path,
                                   **F32_TOL)


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_hybrid_train_step_six_steps_vs_jax(hybrid, bits, microbatch):
    """6 steps of ``make_train_step`` from identical params and optimizer
    state on the same ``DataIterator`` batches, free-running: losses at
    rtol 1e-4, the final params within the module docstring's tolerance;
    with fp32 moments the grad norms at rtol 1e-4 too.

    lr is 3e-3, not the dense test's 1e-2: at 1e-2 this trajectory is
    chaotic, and the reference against itself, from params moved by one
    ulp, parts after 6 steps by 1.0e-4 in the params (fp32 moments, 2
    microbatches; the port's distance 4.3e-5) and 0.34% in the grad norm
    (int8; the port's 0.17%).  At 3e-3 that spread is 1.2e-6 in the
    params with fp32 moments.  With int8 moments a last-bit difference in
    a gradient can move a moment across a code boundary, and the
    reference against itself parts by up to 6e-4 in the grad norm by step
    4 at every lr tried (1e-3 to 1e-2), so there each step's loss and
    grad norm are also held at rtol 1e-4 from the reference's own state
    (the port's step on the reference's params and moments), where no
    earlier step's rounding has moved them; the free-running grad norms
    are held within the reference's own spread from params moved by one
    ulp, over the same 6 steps."""
    jcfg, cfg, jp = hybrid
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20, eps=1e-3,
              state_bits=bits)
    jo, o = jopt.OptConfig(**kw), opt.OptConfig(**kw)
    jshape = JShape("t", "train", seq_len=16, global_batch=4,
                    microbatch=microbatch)
    shape = ShapeConfig("t", "train", seq_len=16, global_batch=4,
                        microbatch=microbatch)
    jstate = {"params": jp, "opt": jopt.init(jp, jo)}
    jp_ulp = jax.tree.map(lambda a: jnp.nextafter(a, jnp.inf), jp)
    jstate_ulp = {"params": jp_ulp, "opt": jopt.init(jp_ulp, jo)}

    def port_state(js):
        st = train.make_train_state(cfg, 0, o, params=port_params(
            js["params"]), device="cpu")
        st["opt"] = interop.opt_state_from_numpy(np_tree(js["opt"]), "cpu")
        return st

    state = port_state(jstate)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jshape, jo))
    step = train.make_train_step(cfg, shape, o)
    jdata = jpipeline.DataIterator(jcfg, jshape, seed=1)
    data = pipeline.DataIterator(cfg, shape, seed=1, device="cpu")
    keys = ("loss", "grad_norm", "lr")
    want, got, forced, ulp = [], [], [], []
    for i in range(6):
        b, jb = data.batch(i), jdata.batch(i)
        for k in jb:
            assert np.array_equal(b[k].numpy(), np.asarray(jb[k]))
        if bits == 8:
            _, m = step(port_state(jstate), b)
            forced.append([float(m[k]) for k in keys])
            jstate_ulp, jm = jstep(jstate_ulp, jb)
            ulp.append(float(jm["grad_norm"]))
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        want.append([float(jm[k]) for k in keys])
        got.append([float(m[k]) for k in keys])
    want, got = np.asarray(want), np.asarray(got)
    if bits == 8:
        np.testing.assert_allclose(np.asarray(forced), want, rtol=1e-4)
        dist = np.abs(got[:, 1] / want[:, 1] - 1).max()
        spread = np.abs(np.asarray(ulp) / want[:, 1] - 1).max()
        assert dist <= spread, (dist, spread)
        got, want = got[:, [0, 2]], want[:, [0, 2]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    tol = dict(atol=2e-3) if bits == 8 else dict(atol=2e-5, rtol=1e-4)
    want_p = dict(flatten(np_tree(jstate["params"])))
    for path, leaf in flatten(state["params"]):
        np.testing.assert_allclose(leaf.detach().numpy(), want_p[path],
                                   err_msg=path, **tol)
    assert int(state["opt"]["step"]) == 6


def test_hybrid_train_runtime_matches_jax(hybrid, tmp_path):
    """``BlockRuntime(kind="train")`` on the hybrid: ``step`` and the
    in-flight window give the JAX block's losses, step for step."""
    jcfg, cfg, jp = hybrid
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
                      devices=["cpu"])
    st = np_tree(jrt.state)
    rt.init_state(params=port_params(st["params"]),
                  opt_state=interop.opt_state_from_numpy(st["opt"], "cpu"))
    for _ in range(2):
        want, got = jrt.step(), rt.step()
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    for r in (jrt, rt):
        r.dispatch()
    want, got = jrt.drain(), rt.drain()
    assert len(got) == len(want) == 1 and rt.inflight_depth == 0
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-4)
    assert rt.step_count == jrt.step_count == 3


def test_hybrid_launcher_train_on_cpu_matches_jax(hybrid, monkeypatch,
                                                  capsys):
    """``launch.train --arch zamba2_2p7b --smoke --device cpu``: its losses
    are the reference's train step's from the launcher's own initial
    params on the same batches and optimizer settings."""
    jcfg = hybrid[0]
    get_smoke = configs.get_smoke
    monkeypatch.setattr(configs, "get_smoke", lambda a: dataclasses.replace(
        get_smoke(a), param_dtype="float32"))
    captured = {}
    init_state = BlockRuntime.init_state

    def capture(self, params=None, opt_state=None):
        init_state(self, params, opt_state)
        captured["params"] = jax.tree.map(
            np.array, interop.params_to_numpy(self.state["params"]))

    monkeypatch.setattr(BlockRuntime, "init_state", capture)
    argv = ["--arch", "zamba2_2p7b", "--smoke", "--device", "cpu", "--steps",
            "3", "--seq-len", "16", "--global-batch", "2", "--log-every",
            "1", "--seed", "4"]
    res = launch_train.run(launch_train.parse_args(argv))
    assert res["cfg"].family == "hybrid"
    got = [h["loss"] for h in res["history"]]
    jp = jax.tree.map(jnp.asarray, captured["params"])
    jo = jopt.OptConfig(lr=3e-4, warmup_steps=1, total_steps=3)
    jshape = JShape("cli", "train", seq_len=16, global_batch=2,
                    microbatch=1)
    jstate = {"params": jp, "opt": jopt.init(jp, jo)}
    jp_ulp = jax.tree.map(lambda a: jnp.nextafter(a, jnp.inf), jp)
    jstate_ulp = {"params": jp_ulp, "opt": jopt.init(jp_ulp, jo)}
    jstep = jax.jit(jtrain.make_train_step(jcfg, jshape, jo))
    jdata = jpipeline.DataIterator(jcfg, jshape, seed=4)
    want = []
    for i in range(3):
        jstate, jm = jstep(jstate, jdata.batch(i))
        want.append(float(jm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert launch_train.main(argv[:-2]) == 0
    out = capsys.readouterr().out
    assert "zamba2_2p7b_smoke" in out and "# done:" in out
