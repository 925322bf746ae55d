"""The moe family's training (deepseek_v2_236b: MLA attention, 2 shared +
routed experts, every layer MoE; llama4_maverick_400b: GQA, top-1 routing,
dense and MoE layers alternating) in the port against the JAX package, on
the CPU at ``get_smoke`` made fp32 on both sides.

Both packages start from the same params (made by the reference's init
functions and moved across with ``interop``) and the same numpy inputs
from a seed; the JAX runs are the reference, through their jnp paths.
Held: the plain flash backward at MLA's head dims against the custom VJP
``_flash_bwd_rule``; ``moe_fwd``'s gradients (x and every leaf, the aux
loss among the outputs) with and without dropped choices; ``loss_fn``'s
value, aux loss and every leaf's gradient; remat against none, bit for
bit; 6-step trajectories at fp32 and int8 moments with 1 and 2
microbatches; the train ``BlockRuntime``; the launcher, whole and with a
config cut in depth; train checkpoints with int8 moments crossing the
packages; ``global_norm``'s chunked sums; chip_smoke's ``train_moe`` at
smoke size, and its routing replay keeping the router's gradient under
remat.

Tolerances, as ``tests/test_torch_vlm_encoder.py`` and
``tests/test_torch_train.py`` have them, each with its reason there: fp32
``atol=1e-5, rtol=1e-4`` (XLA:CPU and ATen sum matmuls in different
orders); trajectories' losses and grad norms ``rtol=1e-4``, params
``atol=2e-5, rtol=1e-4`` with fp32 moments and ``atol=2e-3`` with int8
moments (Adam's eps at 1e-3; a last-bit difference in a gradient can move
an int8 moment across a code boundary, so int8 grad norms are held step
by step from the reference's state:
``test_train_step_six_steps_vs_reference`` says why); int8 codes of a
restored checkpoint equal.  The flash backward against the rule:
``atol=2e-4, rtol=2e-3``, ``tests/test_torch_kernels.py``'s (the rule
sums kv chunks of 16 in a scan, the plain version each row at once).
"""
import dataclasses
import importlib.util
from pathlib import Path

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
from repro.kernels import ops as jops  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jtrain  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.block import BlockGrant  # noqa: E402
from repro_torch.core.runtime import BlockRuntime, JobSpec  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_torch, flash_attention_torch)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model, moe  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.transformer import (flatten,  # noqa: E402
                                             unflatten)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as train  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

F32_TOL = dict(atol=1e-5, rtol=1e-4)
BWD_TOL = dict(atol=2e-4, rtol=2e-3)
ARCHS = ("deepseek_v2_236b", "llama4_maverick_400b")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_params(jp):
    return interop.params_from_numpy(np_tree(jp), "cpu")


def cfgs(arch, **moe_kw):
    """The smoke config in both packages, fp32, with ``moe_kw`` replacing
    fields of its MoE config."""
    out = []
    for get in (jconfigs.get_smoke, configs.get_smoke):
        c = get(arch).replace(param_dtype="float32")
        if moe_kw:
            c = c.replace(moe=dataclasses.replace(c.moe, **moe_kw))
        out.append(c)
    return tuple(out)


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """One moe config's smoke size, fp32, in both packages, with JAX's
    params."""
    jcfg, cfg = cfgs(request.param)
    return jcfg, cfg, jmodel.init_params(jcfg, jax.random.PRNGKey(3))


def batch_of(cfg, seq=32, batch=2, seed=5):
    return pipeline.synthetic_batch(cfg, ShapeConfig("t", "train", seq,
                                                     batch),
                                    step=0, seed=seed)


def torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               **(tol or F32_TOL))


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# ============================================== flash backward, MLA dims

@pytest.mark.parametrize("D,Dv", [(192, 128), (136, 128), (192, 64)])
def test_flash_backward_at_mla_head_dims_vs_reference_rule(D, Dv):
    """The plain backward (the kernel's yardstick on the card) at MLA's
    head dims 192 | 128, at 136 (a third 64-column half mostly zeros on
    the card) and at 192 | 64, causal GQA over 37 positions (no multiple
    of the rule's kv chunk of 16): dq, dk and dv against ``jax.grad``
    through the custom VJP ``_flash_bwd_rule``; ``ops.flash_attention``'s
    autograd runs exactly this backward."""
    rng = np.random.default_rng(D + Dv)
    B, Hq, Hkv, S = 1, 4, 2, 37
    q, k = (rng.standard_normal((B, h, S, D), dtype=np.float32)
            for h in (Hq, Hkv))
    v = rng.standard_normal((B, Hkv, S, Dv), dtype=np.float32)
    ct = rng.standard_normal((B, Hq, S, Dv), dtype=np.float32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o, lse = flash_attention_torch(qt, kt, vt, with_lse=True)
    got = flash_attention_bwd_torch(qt, kt, vt, o, lse, torch.from_numpy(ct))

    def loss(q, k, v):
        return jnp.sum(jops._flash_jnp(q, k, v, True, 0, None, 0, 16) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for g, w, shape in zip(got, want, (q.shape, k.shape, v.shape)):
        assert tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out = ops.flash_attention(*leaves, impl="torch")
    (out * torch.from_numpy(ct)).sum().backward()
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


# =============================================================== the layer

@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_fwd_grads_vs_reference(arch, capacity_factor):
    """The MoE layer's output, aux loss and the gradients of x and of
    every leaf (the fp32 router, the stacked ``w_gate``/``w_up``/``w_down``
    and the shared experts) against ``jax.grad`` of the reference's
    ``moe_fwd``, on 2 x 24 tokens, under a loss that weighs the output by
    a random cotangent and adds 3 x the aux loss.  At the default capacity
    factor choices drop (the test shows it): the reference's ``mode="drop"``
    scatter gives them zero gradient, the port's trash row too; at 16 none
    drops.  The router gets gradient through the gates and the aux loss."""
    jcfg, cfg = cfgs(arch, capacity_factor=capacity_factor)
    d = cfg.d_model
    jp = jmoe.moe_init(jax.random.PRNGKey(7), d, jcfg.moe, jnp.float32)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 24, d), dtype=np.float32)
    ct = rng.standard_normal((2, 24, d), dtype=np.float32)
    p = {k: v.requires_grad_(True) for k, v in flatten(port_params(jp))}
    tree = unflatten(p.items())
    _, _, slots, _, C = moe.route(torch.from_numpy(x).reshape(-1, d),
                                  tree["router"], cfg.moe)
    dropped = int((slots == cfg.moe.n_experts * C).sum())
    if capacity_factor == 1.25:
        assert dropped > 0, "no choice overflowed: the drop path is not run"
    else:
        assert dropped == 0

    def jloss(jp, x):
        out, aux = jmoe.moe_fwd(jp, x, jcfg.moe, jcfg.act)
        return jnp.sum(out * ct) + 3.0 * aux, (out, aux)

    (_, (wout, waux)), (wg, wx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_fwd(tree, xt, cfg.moe, cfg.act)
    (torch.sum(out * torch.from_numpy(ct)) + 3.0 * aux).backward()
    assert_close(out, wout)
    assert_close(aux, waux)
    assert_close(xt.grad, wx)
    want = dict(flatten(np_tree(wg)))
    assert set(want) == set(p)
    for path, leaf in p.items():
        np.testing.assert_allclose(leaf.grad.numpy(), want[path],
                                   err_msg=path, **F32_TOL)
    assert float(p["router"].grad.abs().max()) > 0


# ============================================================== loss, grads

def test_loss_fn_value_aux_and_every_grad_vs_reference(fam):
    """``loss_fn``: the total (next-token loss plus the routers' aux loss),
    the ``loss`` and ``aux_loss`` it reports, and every leaf's gradient
    (the routers', the experts', MLA's or the dense halves' among them)
    against ``jax.value_and_grad`` of the reference's."""
    jcfg, cfg, jp = fam
    nb = batch_of(cfg)

    def jloss(p):
        return jmodel.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in nb.items()})

    (want_l, want_m), want_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jp)
    params = port_params(jp)
    for _, leaf in flatten(params):
        leaf.requires_grad_(True)
    with torch.no_grad():
        total, metrics = model.loss_fn(params, cfg, torch_batch(nb))
    np.testing.assert_allclose(float(total), float(want_l), **F32_TOL)
    for k in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[k]), float(want_m[k]),
                                   **F32_TOL)
    assert float(metrics["aux_loss"]) > 0
    np.testing.assert_allclose(float(total), float(metrics["loss"]
                                                   + metrics["aux_loss"]),
                               rtol=1e-6)
    got_l, got_g = train.value_and_grad(params, cfg, torch_batch(nb))
    assert float(got_l) == float(total)
    want_flat, got_flat = dict(flatten(np_tree(want_g))), dict(flatten(got_g))
    assert set(got_flat) == set(want_flat)
    routers = [p for p in got_flat if p.endswith("router")]
    assert routers and all(float(got_flat[p].abs().max()) > 0
                           for p in routers)
    for path, g in got_flat.items():
        np.testing.assert_allclose(g.numpy(), want_flat[path], err_msg=path,
                                   **F32_TOL)


def test_remat_routes_as_the_first_forward_and_gives_the_same_grads(fam):
    """``remat="full"`` recomputes each group, its MoE routing included,
    in the backward: the grads (and the loss) are those of the plain
    forward, bit for bit."""
    jcfg, cfg, jp = fam
    nb = torch_batch(batch_of(cfg))
    out = []
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        st = train.make_train_state(c, 0, opt.OptConfig(),
                                    params=port_params(jp), device="cpu")
        out.append(train.value_and_grad(st["params"], c, nb))
    assert float(out[0][0]) == float(out[1][0])
    for (p, a), (_, b) in zip(flatten(out[0][1]), flatten(out[1][1])):
        assert torch.equal(a, b), p


# ============================================================ trajectories

@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_six_steps_vs_reference(fam, bits, microbatch):
    """6 steps of ``make_train_step`` from identical params and optimizer
    state on the same ``DataIterator`` batches, free-running: losses (the
    total with the aux loss) and learning rates at rtol 1e-4, the final
    params within the module docstring's tolerance; with fp32 moments the
    grad norms at rtol 1e-4 too.  With 2 microbatches each call's
    capacity comes from its own tokens, as in the reference.

    With int8 moments a last-bit difference in a gradient can move a
    moment across a code boundary, and the update of that element jumps
    by about lr: the free-running grad norms then part past rtol 1e-4,
    in the reference against itself from params moved by one ulp as in
    the port (``tests/test_torch_hybrid_train.py`` measured it for the
    hybrid).  So with int8 moments each step's loss and grad norm are
    held at rtol 1e-4 from the reference's own state (the port's step on
    the reference's params and moments), where no earlier step's
    rounding has moved them, and of the free-running trajectory the
    losses, learning rates and final params."""
    jcfg, cfg, jp = fam
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, eps=1e-3,
              state_bits=bits)
    jo, o = jopt.OptConfig(**kw), opt.OptConfig(**kw)
    jshape = JShape("t", "train", seq_len=16, global_batch=4,
                    microbatch=microbatch)
    shape = ShapeConfig("t", "train", seq_len=16, global_batch=4,
                        microbatch=microbatch)
    jstate = {"params": jp, "opt": jopt.init(jp, jo)}

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
    want, got, forced = [], [], []
    for i in range(6):
        b, jb = data.batch(i), jdata.batch(i)
        for k in jb:
            assert np.array_equal(b[k].numpy(), np.asarray(jb[k])), k
        if bits == 8:
            _, m = step(port_state(jstate), b)
            forced.append([float(m[k]) for k in keys])
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        want.append([float(jm[k]) for k in keys])
        got.append([float(m[k]) for k in keys])
    want, got = np.asarray(want), np.asarray(got)
    if bits == 8:
        np.testing.assert_allclose(np.asarray(forced), want, rtol=1e-4)
        got, want = got[:, [0, 2]], want[:, [0, 2]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    tol = dict(atol=2e-3) if bits == 8 else dict(atol=2e-5, rtol=1e-4)
    want_p = dict(flatten(np_tree(jstate["params"])))
    for path, leaf in flatten(state["params"]):
        np.testing.assert_allclose(leaf.detach().numpy(), want_p[path],
                                   err_msg=path, **tol)
    assert int(state["opt"]["step"]) == 6


def test_global_norm_sums_a_large_leaf_in_chunks(monkeypatch):
    """``global_norm`` squares and sums a leaf past ``NORM_CHUNK`` elements
    chunk by chunk (a full-width expert leaf's fp32 square would take 20
    GB); a leaf within it is summed whole, as before, bit for bit; the
    norm is the reference's at fp32's rounding."""
    rng = np.random.default_rng(3)
    tree = {"big": rng.standard_normal((50, 100), dtype=np.float32),
            "small": rng.standard_normal((7, 9), dtype=np.float32)}
    monkeypatch.setattr(opt, "NORM_CHUNK", 1000)
    t = {k: torch.from_numpy(v) for k, v in tree.items()}
    got = opt.global_norm(t)
    want = jopt.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert torch.equal(opt._sq_sum(t["small"]),
                       torch.sum(t["small"].float() ** 2))
    assert opt.NORM_CHUNK < t["big"].numel()


# ============================================================= the runtime

def jobs(jcfg, cfg, bits=None, **shape):
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3,
              state_bits=bits)
    shape = shape or dict(seq_len=16, global_batch=2)
    return (JJob(jcfg, JShape("t", "train", **shape), kind="train",
                 opt=jopt.OptConfig(**kw), seed=2, collect_metrics=True,
                 ckpt_namespace="moe"),
            JobSpec(cfg, ShapeConfig("t", "train", **shape), kind="train",
                    opt=opt.OptConfig(**kw), seed=2, collect_metrics=True,
                    ckpt_namespace="moe"))


def test_train_runtime_matches_reference(fam, tmp_path):
    """``BlockRuntime(kind="train")`` with int8 moments from the reference
    block's state: ``step`` and the in-flight window give its losses,
    grad norms and learning rates, step for step."""
    jcfg, cfg, _ = fam
    jjob, job = jobs(jcfg, cfg, bits=8)
    jrt = JRuntime(JGrant.new([(0, 0, 0)], (1, 1), 60.0), jjob,
                   [jax.devices()[0]], str(tmp_path / "j"))
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


# ============================================================ the launcher

def reference_losses(jcfg, params, n, bits=None, seq=16, seed=4):
    """The reference's train step on ``params`` (numpy) with the
    launcher's optimizer settings for ``n`` steps: its losses."""
    jp = jax.tree.map(jnp.asarray, params)
    jo = jopt.OptConfig(lr=3e-4, warmup_steps=1, total_steps=n,
                        state_bits=bits)
    jshape = JShape("cli", "train", seq_len=seq, global_batch=2,
                    microbatch=1)
    jstate = {"params": jp, "opt": jopt.init(jp, jo)}
    jstep = jax.jit(jtrain.make_train_step(jcfg, jshape, jo))
    jdata = jpipeline.DataIterator(jcfg, jshape, seed=seed)
    out = []
    for i in range(n):
        jstate, jm = jstep(jstate, jdata.batch(i))
        out.append(float(jm["loss"]))
    return out


def capture_init(monkeypatch):
    captured = {}
    init_state = BlockRuntime.init_state

    def capture(self, params=None, opt_state=None):
        init_state(self, params, opt_state)
        captured["params"] = jax.tree.map(
            np.array, interop.params_to_numpy(self.state["params"]))
        captured["opt"] = self.state["opt"]

    monkeypatch.setattr(BlockRuntime, "init_state", capture)
    return captured


def test_launcher_trains_deepseek_v2_as_the_reference(monkeypatch, capsys):
    """``launch.train --arch deepseek_v2_236b --smoke --device cpu``: its
    losses are the reference's train step's from the launcher's own
    initial params on the same batches and optimizer settings."""
    get_smoke = configs.get_smoke
    monkeypatch.setattr(configs, "get_smoke", lambda a: dataclasses.replace(
        get_smoke(a), param_dtype="float32"))
    captured = capture_init(monkeypatch)
    argv = ["--arch", "deepseek_v2_236b", "--smoke", "--device", "cpu",
            "--steps", "3", "--seq-len", "16", "--global-batch", "2",
            "--log-every", "1", "--seed", "4"]
    res = launch_train.run(launch_train.parse_args(argv))
    assert res["cfg"].family == "moe" and res["cfg"].attention.is_mla
    got = [h["loss"] for h in res["history"]]
    jcfg = cfgs("deepseek_v2_236b")[0]
    np.testing.assert_allclose(
        got, reference_losses(jcfg, captured["params"], 3), rtol=1e-4)
    assert launch_train.main(argv[:-2]) == 0
    out = capsys.readouterr().out
    assert "deepseek_v2_236b_smoke" in out and "# done:" in out


def test_launcher_run_takes_a_config_cut_in_depth(monkeypatch):
    """``run(args, cfg, state_bits=8)``: the block trains the caller's
    config (llama4 cut to one dense + MoE group) with int8 moments, and
    its losses are the reference's on that config."""
    captured = capture_init(monkeypatch)
    jcfg, cfg = (c.replace(n_layers=2) for c in cfgs("llama4_maverick_400b"))
    args = launch_train.parse_args(
        ["--arch", "llama4_maverick_400b", "--smoke", "--device", "cpu",
         "--steps", "3", "--seq-len", "16", "--global-batch", "2",
         "--seed", "4"])
    res = launch_train.run(args, cfg, state_bits=8)
    assert res["cfg"] is cfg and res["runtime"].job.opt.state_bits == 8
    assert set(captured["opt"]["m"]["layers"]["moe"]["moe"]["router"]) == {
        "q", "s"}
    assert captured["params"]["layers"]["moe"]["moe"]["w_up"].shape[0] == 1
    got = [h["loss"] for h in res["history"]]
    np.testing.assert_allclose(
        got, reference_losses(jcfg, captured["params"], 3, bits=8),
        rtol=1e-4)


# ============================================================ checkpoints

def leaf_bits(tree):
    """[(dtype, shape, bytes)] of every leaf in ``jax.tree`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_bits(tree[k])]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        return [(str(t.dtype).removeprefix("torch."), tuple(t.shape),
                 t.reshape(-1).view(torch.uint8).numpy().tobytes())]
    a = np.asarray(tree)
    return [(str(a.dtype), a.shape, a.tobytes())]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_int8_train_checkpoint_crosses_packages(writer, tmp_path):
    """deepseek_v2's train block with int8 moments: one package saves
    after 2 steps, the other restores it leaf for leaf and bit for bit
    (params, int8 codes and their scales, the fp32 router's moments), and
    both take 2 more steps with the same losses, grad norms and learning
    rates."""
    jjob, job = jobs(*cfgs("deepseek_v2_236b"), bits=8)
    root = str(tmp_path)
    new = (lambda: JRuntime(JGrant.new([(0, 0, 0)], (1, 1), 60.0), jjob,
                            [jax.devices()[0]], root),
           lambda: BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0),
                                job, devices=["cpu"], ckpt_root=root))
    first, second = new if writer == "reference" else new[::-1]
    a = first()
    a.init_state()
    a.step(), a.step()
    a.save(async_=False)
    b = second()
    assert b.restore() == 2
    jrt, rt = (a, b) if writer == "reference" else (b, a)
    assert leaf_bits(rt.state) == leaf_bits(np_tree(jrt.state))
    m = rt.state["opt"]["m"]["layers"]["moe"]
    assert m["w_gate"]["q"].dtype == torch.int8
    assert m["router"]["s"].dtype == torch.float32
    for _ in range(2):
        want, got = jrt.step(), rt.step()
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


# ======================================================= chip_smoke's phase

def test_routing_replay_keeps_the_router_gradient_under_remat():
    """``chip_smoke.RoutingTape``: a run that replays its own recorded
    routing (remat on, so each MoE layer routes twice, in the forward and
    in the backward's recompute) gives the free run's loss and every
    gradient bit for bit, the routers' (through the gates and the aux
    loss) among them; on other params it recomputes the gates from their
    router, whose gradient then differs from the recording run's."""
    smoke = _chip_smoke()
    cfg = configs.get_smoke("deepseek_v2_236b").replace(
        param_dtype="float32")
    assert cfg.remat != "none"
    params = model.init_params(cfg, seed=1, device="cpu")
    for _, leaf in flatten(params):
        leaf.requires_grad_(True)
    nb = torch_batch(batch_of(cfg))
    free = train.value_and_grad(params, cfg, nb)
    with smoke.RoutingTape() as tape:
        rec = train.value_and_grad(params, cfg, nb)
        tape.set("replay")
        rep = train.value_and_grad(params, cfg, nb)
        assert len(tape.first) == cfg.n_layers
        other = model.init_params(cfg, seed=2, device="cpu")
        for _, leaf in flatten(other):
            leaf.requires_grad_(True)
        with pytest.raises(KeyError):       # other routers, no recording
            train.value_and_grad(other, cfg, nb)
    assert tape.recompute_changed == 0
    for run in (rec, rep):
        assert float(run[0]) == float(free[0])
        for (p, a), (_, b) in zip(flatten(run[1]), flatten(free[1])):
            assert torch.equal(a, b), p
    router = free[1]["layers"]["moe"]["router"]
    assert float(router.abs().max()) > 0
    # the replayed gates are this call's: another router's probabilities
    # at the recorded choices give other gates
    xs = torch.randn(10, cfg.d_model)
    r1 = moe.route(xs, params["layers"]["moe"]["router"][0], cfg.moe)
    r2 = tape.replayed(xs, other["layers"]["moe"]["router"][0], cfg.moe,
                       r1[1], r1[2], r1[4])
    assert torch.equal(r2[1], r1[1]) and torch.equal(r2[2], r1[2])
    assert not torch.equal(r2[3], r1[3])


def test_chip_smoke_train_moe_rehearses_on_cpu():
    """``chip_smoke.py``'s ``train_moe`` at smoke size on the CPU: step 0
    against ``impl="torch"`` with the plain run's routing replayed (both
    plain here), remat's recomputes routing as the first forward, 3 steps
    through the launcher's ``run(args, cfg)``, whose step 0 is the
    check's loss, no kernel launched, the capacity's drop share read."""
    out = _chip_smoke().phase_train_moe(device="cpu", smoke=True)
    assert out["arch"] == "deepseek_v2_236b_smoke" and out["steps"] == 3
    chk = out["step0_check"]
    assert chk["within_rtol"] and chk["recompute_changed"] == 0
    assert chk["own_routing"]["tokens_rerouted_by_layer"] == [0, 0]
    assert out["launcher_step0_loss_equals_check"]
    assert set(out["launches"].values()) == {0}
    assert all(np.isfinite(out["losses"]))
    assert 0.0 <= out["capacity_drop"]["dropped_share"] <= 1.0
