"""The port's train block over several devices (item 8a), on gloo ranks on
the CPU, against the JAX package's run on the same mesh shape.

The ranks are subprocesses, one per device, joined through a
``FileStore`` in the test's directory (no port, so parallel test workers
never collide), each with ``torch.set_num_threads(1)``, a subprocess
timeout and a collective timeout.  The JAX package runs once in a
subprocess with 4 forced host devices (``REF``): it writes its runs'
metrics and checkpoints, and the port's worlds of 4, 2 and 1 ranks
(``RANKS``) read them and print one JSON line each, which the tests below
read through module-scoped fixtures.

The configs are the smoke configs in fp32 (the ranks' sums in another
order than one device's move bf16 results by whole bf16 steps), and the
tolerances, each beside what the reference against itself gives:
* llama4_maverick_400b (MoE, routing per data shard) at (2, 2), 3 steps
  from the JAX init: losses and grad norms at rtol 1e-4 against the
  reference's (2, 2) run (measured: 3e-7).  Against the port's (1, 1) run the routing
  groups differ (one shard of 8 rows against two of 4), so the losses
  part as the reference's own (2, 2) and (1, 1) runs do: rtol 2e-2,
  atol 2e-2, the reference's own test's bound
  (``tests/test_multidevice.py``); ``test_llama4_22_against_11`` also
  holds the port's gap within 1.5x the reference's own gap plus 1e-4.
* deepseek_7b at (2, 1) and (1, 2), int8 moments, 2 microbatches, Adam's
  eps 1e-3 (as ``tests/test_torch_train.py``, whose docstring gives the
  reason): losses at rtol 1e-4 over 3 free-running steps and the params
  after them at atol 2e-3; the grad norms step by step from the
  reference's checkpointed state, at rtol 1e-4.
* hubert_xlarge at (2, 1) against one rank: the loss at rtol 1e-5, every
  grad at rtol 1e-4, atol 1e-6 (only the order of the sums differs).
* the aux loss and the MoE layer's output at DP = 2 against the
  reference's ``moe_fwd`` under its (2, 1) mesh: rtol 1e-5, atol 1e-6.
* a straddling int8 leaf's update and every checkpoint crossing: bit for
  bit.
* the launcher on 2 ranks (a (1, 2) mesh: the model axis's ranks
  compute the same rows) against 1 rank, bf16 smoke config, fp32
  moments: losses at rtol 1e-3 (measured: equal to the last bit).
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu")

torch.set_num_threads(1)

REF = r'''
import dataclasses, json, sys
import jax, numpy as np
import repro.configs as C
from repro.checkpoint.manager import CheckpointManager
from repro.data import pipeline
from repro.models import model as model_lib, moe as moe_lib
from repro.models.config import ShapeConfig
from repro.sharding import ctx as shard_ctx, plans
from repro.train import optimizer as opt_lib, train_step as train_lib

out = sys.argv[1]
res = {}


def fp32(arch):
    return dataclasses.replace(C.get_smoke(arch), param_dtype="float32")


def mesh_of(shape):
    devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return jax.sharding.Mesh(devs, ("data", "model"))


def run(ns, cfg, shape, opt_cfg, mesh_shape, n):
    mesh = mesh_of(mesh_shape)
    axes = plans.MeshAxes(dp=("data",), model="model")
    ctx = shard_ctx.ShardCtx(mesh, ("data",), "model")
    state_abs = train_lib.abstract_train_state(cfg, opt_cfg)
    p_spec = plans.param_specs(state_abs["params"], mesh, axes)
    sh = plans.to_shardings({"params": p_spec, "opt": plans.opt_state_specs(
        state_abs["opt"], p_spec)}, mesh)
    step = train_lib.make_train_step(cfg, shape, opt_cfg)

    def fn(state, b):
        with shard_ctx.use(ctx):
            return step(state, b)

    jstep = jax.jit(fn, in_shardings=(sh, None), out_shardings=(sh, None))
    state = jax.device_put(train_lib.make_train_state(
        cfg, jax.random.PRNGKey(0), opt_cfg), sh)
    data = pipeline.DataIterator(cfg, shape, seed=0)
    mgr = CheckpointManager(out, ns, keep=10) if ns else None
    if mgr:
        mgr.save(0, {"state": state, "step_count": 0})
    hist = []
    for i in range(n):
        state, m = jstep(state, data.batch(i))
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        if mgr:
            mgr.save(i + 1, {"state": state, "step_count": i + 1})
    return hist


L4 = fp32("llama4_maverick_400b")
L4_SHAPE = ShapeConfig("t", "train", seq_len=32, global_batch=8, microbatch=2)
L4_OPT = opt_lib.OptConfig(warmup_steps=1, total_steps=4)
res["llama4_22"] = run("llama4", L4, L4_SHAPE, L4_OPT, (2, 2), 3)
res["llama4_11"] = run(None, L4, L4_SHAPE, L4_OPT, (1, 1), 3)

DS = fp32("deepseek_7b")
DS_SHAPE = ShapeConfig("t", "train", seq_len=16, global_batch=4, microbatch=2)
DS_OPT = opt_lib.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20, eps=1e-3,
                           state_bits=8)
for d, m in ((2, 1), (1, 2)):
    res[f"ds_{d}{m}"] = run(f"ds_{d}{m}", DS, DS_SHAPE, DS_OPT, (d, m), 3)

# the MoE layer at DP = 2: group 0's MoE sublayer of llama4 on 4 x 8 tokens
params = model_lib.init_params(L4, jax.random.PRNGKey(1))
p = jax.tree.map(lambda l: l[0], params["layers"]["moe"]["moe"])
x = np.random.default_rng(0).standard_normal((4, 8, L4.d_model),
                                             dtype=np.float32)
mesh = mesh_of((2, 1))
ctx = shard_ctx.ShardCtx(mesh, ("data",), "model")


def layer(p, x):
    with shard_ctx.use(ctx):
        return moe_lib.moe_fwd(p, x, L4.moe)


y, aux = jax.jit(layer)(p, x)
_, aux1 = moe_lib.moe_fwd(p, x, L4.moe)
flat = {"/".join(k.key for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(p)[0]}
np.savez(f"{out}/moe_dp2.npz", x=x, y=np.asarray(y), aux=np.asarray(aux),
         aux_dp1=np.asarray(aux1), **{"p/" + k: v for k, v in flat.items()})
print(json.dumps(res))
'''

RANKS = r'''
import dataclasses, hashlib, json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out, ref = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
from repro_torch import device as D
D.init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                   world_size=world, timeout_s=300)
import repro_torch.configs as C
from repro_torch.core.block import BlockGrant
from repro_torch.core.runtime import BlockRuntime, JobSpec
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import flatten, unflatten
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.train import optimizer as opt_lib, train_step as train_lib
from torch.distributed.tensor import DTensor

res = {}


def fp32(arch):
    return dataclasses.replace(C.get_smoke(arch), param_dtype="float32")


L4 = fp32("llama4_maverick_400b")
L4_SHAPE = ShapeConfig("t", "train", seq_len=32, global_batch=8, microbatch=2)
L4_OPT = opt_lib.OptConfig(warmup_steps=1, total_steps=4)
DS = fp32("deepseek_7b")
DS_SHAPE = ShapeConfig("t", "train", seq_len=16, global_batch=4, microbatch=2)
DS_OPT = opt_lib.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20, eps=1e-3,
                           state_bits=8)


def block(mesh, cfg, shape, opt, root=None, ns=None):
    n = mesh[0] * mesh[1]
    job = JobSpec(cfg, shape, kind="train", opt=opt, seed=0,
                  ckpt_namespace=ns)
    grant = BlockGrant.new([(0, i, 0) for i in range(n)], mesh, 600.0)
    return BlockRuntime(grant, job, devices=["cpu"] * n, ckpt_root=root)


def whole(t):
    return t.detach().full_tensor() if isinstance(t, DTensor) else t.detach()


def digests(tree):
    return {p: hashlib.sha256(whole(t).contiguous().reshape(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest() for p, t in flatten(tree)}


def steps(rt, n):
    return [[m["loss"], m["grad_norm"]] for m in (rt.step() for _ in range(n))]


def save_npz(name, tree):
    arrs = {p: whole(t).float().numpy() for p, t in flatten(tree)}
    if rank == 0:
        np.savez(os.path.join(out, name), **arrs)


def grads_of(mesh, cfg, shape):
    rt = block(mesh, cfg, shape, opt_lib.OptConfig())
    rt.init_state()
    with shard_ctx.use(rt.ctx):
        loss, grads = train_lib.value_and_grad(rt.state["params"], cfg,
                                               rt.data.batch(0))
    return float(loss), grads


def launcher():
    from repro_torch.launch import train as launch_train
    args = launch_train.parse_args(
        ["--arch", "deepseek_7b", "--smoke", "--device", "cpu", "--steps", "3",
         "--seq-len", "16", "--global-batch", "4", "--log-every", "100"])
    r = launch_train.run(args)
    return [h["loss"] for h in r["history"]]


def restore_digests(mesh):
    rt = block(mesh, DS, DS_SHAPE, DS_OPT, out, "port22")
    rt.restore()
    return {"digests": digests(rt.state), "step": rt.step_count}


if world == 4:
    rt = block((2, 2), L4, L4_SHAPE, L4_OPT, ref, "llama4")
    assert rt.restore(step=0) == 0          # a JAX checkpoint at (2, 2)
    res["jax_init_digests"] = digests(rt.state)
    res["llama4_22"] = steps(rt, 3)
    rt = block((2, 2), DS, DS_SHAPE, DS_OPT, out, "port22")
    rt.init_state()
    steps(rt, 1)
    rt.save(async_=False)
    res["saved_22"] = {"digests": digests(rt.state), "step": rt.step_count}
    # a preemption resumed on another mesh shape over the same ranks
    rt.suspend()
    rt.resume(BlockGrant.new([(0, i, 0) for i in range(4)], (4, 1), 600.0),
              ["cpu"] * 4)
    res["resumed_41"] = {"digests": digests(rt.state), "step": rt.step_count,
                         "mesh": list(rt.mesh.mesh.shape)}
elif world == 2:
    for d, m in ((2, 1), (1, 2)):
        rt = block((d, m), DS, DS_SHAPE, DS_OPT, ref, f"ds_{d}{m}")
        forced = []
        for k in range(3):
            rt.restore(step=k)
            forced.append(steps(rt, 1)[0])
        rt.restore(step=0)
        res[f"ds_{d}{m}"] = {"forced": forced, "free": steps(rt, 3)}
        save_npz(f"ds_{d}{m}_params.npz", rt.state["params"])
    loss, grads = grads_of((2, 1), fp32("hubert_xlarge"),
                           ShapeConfig("t", "train", 16, 4, 1))
    res["hubert"] = loss
    save_npz("hubert_2.npz", grads)
    # the MoE layer at DP = 2: this rank's shard of the tokens
    from repro_torch.launch.mesh import make_block_mesh
    from repro_torch.models.moe import moe_fwd
    z = np.load(os.path.join(ref, "moe_dp2.npz"))
    p = unflatten((k[2:], torch.from_numpy(z[k])) for k in z.files
                  if k.startswith("p/"))
    mesh = make_block_mesh(range(2), (2, 1))
    ctx = shard_ctx.ShardCtx(mesh, ("data",), "model", shards_batch=True)
    x = torch.from_numpy(z["x"])
    with shard_ctx.use(ctx):
        y, aux = moe_fwd(p, x[2 * rank:2 * rank + 2], L4.moe)
    ys = [torch.empty_like(y) for _ in range(2)]
    dist.all_gather(ys, y)
    res["moe_dp2"] = {"aux": float(aux),
                      "y_err": float((torch.cat(ys) - torch.from_numpy(
                          z["y"])).abs().max()),
                      "y_scale": float(np.abs(z["y"]).max())}
    # an int8 leaf whose blocks straddle the shard of its last dim
    from repro_torch.sharding import plans
    s = np.load(os.path.join(out, "straddle_in.npz"))
    mesh = make_block_mesh(range(2), (1, 2))
    spec = plans.param_specs({"w_up": torch.empty(8, 768, device="meta")},
                             mesh)["w_up"]
    uspec = plans.update_spec(spec, (8, 768), mesh)
    lay_p = plans.Layout(mesh, plans.to_placements(spec, mesh))
    lay_q = plans.Layout(mesh, plans.to_placements(uspec, mesh))
    lay_s = plans.Layout(mesh, plans.to_placements(
        plans.scale_spec(uspec, (8, 768), mesh), mesh))
    t = lambda k: torch.from_numpy(s[k])
    pd, gd = lay_p.shard(t("p")), lay_p.shard(t("g"))
    m = {"q": lay_q.shard(t("mq")), "s": lay_s.shard(t("ms"))}
    v = {"q": lay_q.shard(t("vq")), "s": lay_s.shard(t("vs"))}
    sc = [torch.tensor(float(s[k]), dtype=torch.float32)
          for k in ("lr", "scale", "bc1", "bc2")]
    opt_lib._adamw_leaf(pd, gd, m, v, "torch", lr=sc[0], scale=sc[1],
                        bc1=sc[2], bc2=sc[3], b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.1)
    res["straddle"] = {
        "spec": [str(e) for e in spec], "update_spec": [str(e) for e in uspec],
        "local_q": list(m["q"].to_local().shape),
        "out": {k: hashlib.sha256(whole(x).contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()).hexdigest() for k, x in (
            ("p", pd), ("mq", m["q"]), ("ms", m["s"]), ("vq", v["q"]),
            ("vs", v["s"]))}}
    res["restored_12"] = restore_digests((1, 2))
    # a sharded block's random init is the unsharded one's, sliced, and
    # given whole trees are sliced as they are
    whole_state = train_lib.make_train_state(DS, 0, DS_OPT, device="cpu")
    want = digests(whole_state)
    got = []
    for given in (False, True):
        rt = block((1, 2), DS, DS_SHAPE, DS_OPT)
        if given:
            rt.init_state(params=whole_state["params"],
                          opt_state=whole_state["opt"])
        else:
            rt.init_state()
        got.append(digests(rt.state) == want)
    res["init_equals_unsharded"] = got
    res["launcher"] = launcher()
    # on the card the backward (remat's recompute among it) runs on the
    # autograd engine's device thread, where the caller's context is not
    # installed: a backward outside the context gives the same grads
    from repro_torch.models import model as model_lib
    rt = block((2, 1), L4, L4_SHAPE, L4_OPT)
    rt.init_state()
    leaves = [t for _, t in flatten(rt.state["params"])]
    batch = rt.data.batch(0)
    grads = []
    for inside in (True, False):
        with shard_ctx.use(rt.ctx):
            loss, _ = model_lib.loss_fn(rt.state["params"], L4, batch)
            if inside:
                grads.append(torch.autograd.grad(loss, leaves))
        if not inside:
            grads.append(torch.autograd.grad(loss, leaves))
    res["backward_outside_ctx_equal"] = all(
        torch.equal(whole(a), whole(b)) for a, b in zip(*grads))
else:
    rt = block((1, 1), L4, L4_SHAPE, L4_OPT, ref, "llama4")
    rt.restore(step=0)
    res["llama4_11"] = steps(rt, 3)
    loss, grads = grads_of((1, 1), fp32("hubert_xlarge"),
                           ShapeConfig("t", "train", 16, 4, 1))
    res["hubert"] = loss
    save_npz("hubert_1.npz", grads)
    res["restored_11"] = restore_digests((1, 1))
    res["launcher"] = launcher()
if rank == 0:
    print("RESULT " + json.dumps(res))
dist.destroy_process_group()
'''


def _spawn(world, tmp, ref):
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    store = tmp / f"store_{world}"
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(store),
         str(tmp), str(ref)], env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _collect(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{so}\n{se[-4000:]}"
    line = [x for x in outs[0][0].splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def _straddle_case():
    rng = np.random.default_rng(7)
    from repro.train import quantized_state as jqs
    p = rng.standard_normal((8, 768)).astype(np.float32)
    g = rng.standard_normal((8, 768)).astype(np.float32)
    m = jqs.quantize(jnp.asarray(rng.standard_normal((8, 768)) * 0.1,
                                 jnp.float32))
    v = jqs.quantize(jnp.asarray(rng.random((8, 768)) * 0.01, jnp.float32))
    return dict(p=p, g=g, mq=np.asarray(m["q"]), ms=np.asarray(m["s"]),
                vq=np.asarray(v["q"]), vs=np.asarray(v["s"]),
                lr=np.float32(3e-3), scale=np.float32(0.7),
                bc1=np.float32(0.19), bc2=np.float32(0.0975))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's runs, then the port's worlds of 4, 2 and 1 ranks;
    {"ref", 4, 2, 1: their JSON lines, "dir": where they wrote}."""
    tmp = tmp_path_factory.mktemp("md")
    ref = tmp / "ref"
    ref.mkdir()
    r = subprocess.run([sys.executable, "-c", REF, str(ref)], env=dict(
        ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    out = {"ref": json.loads(r.stdout.splitlines()[-1]), "dir": tmp}
    np.savez(tmp / "straddle_in.npz", **_straddle_case())
    out[4] = _collect(_spawn(4, tmp, ref))
    two, one = _spawn(2, tmp, ref), _spawn(1, tmp, ref)
    out[2], out[1] = _collect(two), _collect(one)
    return out


def test_llama4_22_matches_the_reference_22(runs):
    np.testing.assert_allclose(runs[4]["llama4_22"], runs["ref"]["llama4_22"],
                               rtol=1e-4)


def test_llama4_22_against_11(runs):
    got22, got11 = (np.asarray(runs[4]["llama4_22"])[:, 0],
                    np.asarray(runs[1]["llama4_11"])[:, 0])
    want22, want11 = (np.asarray(runs["ref"]["llama4_22"])[:, 0],
                      np.asarray(runs["ref"]["llama4_11"])[:, 0])
    np.testing.assert_allclose(got11, want11, rtol=1e-4)
    np.testing.assert_allclose(got22, got11, rtol=2e-2, atol=2e-2)
    assert np.all(np.abs(got22 - got11)
                  <= 1.5 * np.abs(want22 - want11) + 1e-4)


@pytest.mark.parametrize("mesh", ["21", "12"])
def test_deepseek_int8_two_microbatches_vs_reference(runs, mesh):
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.train import optimizer as jopt
    from repro.train import train_step as jtrain
    import repro.configs as JC
    got, want = runs[2][f"ds_{mesh}"], np.asarray(runs["ref"][f"ds_{mesh}"])
    np.testing.assert_allclose(np.asarray(got["free"])[:, 0], want[:, 0],
                               rtol=1e-4)
    # grad norms from the reference's state at every step
    np.testing.assert_allclose(np.asarray(got["forced"]), want, rtol=1e-4)
    cfg = dataclasses.replace(JC.get_smoke("deepseek_7b"),
                              param_dtype="float32")
    opt = jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20, eps=1e-3,
                         state_bits=8)
    like = {"state": jtrain.abstract_train_state(cfg, opt), "step_count": 0}
    ref, at = JManager(str(runs["dir"] / "ref"), f"ds_{mesh}").restore(
        like, step=3)
    assert at == 3
    mine = np.load(runs["dir"] / f"ds_{mesh}_params.npz")
    flat = jax.tree_util.tree_flatten_with_path(ref["state"]["params"])[0]
    assert len(flat) == len(mine.files)
    for path, leaf in flat:
        name = "/".join(k.key for k in path)
        np.testing.assert_allclose(mine[name], np.asarray(leaf), atol=2e-3,
                                   err_msg=name)


def test_hubert_masked_loss_and_grads_on_two_ranks_equal_one(runs):
    assert runs[2]["hubert"] == pytest.approx(runs[1]["hubert"], rel=1e-5)
    two = np.load(runs["dir"] / "hubert_2.npz")
    one = np.load(runs["dir"] / "hubert_1.npz")
    assert sorted(two.files) == sorted(one.files) and len(one.files) > 10
    for k in one.files:
        np.testing.assert_allclose(two[k], one[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_aux_loss_and_moe_layer_at_dp2_vs_reference(runs):
    z = np.load(runs["dir"] / "ref" / "moe_dp2.npz")
    got = runs[2]["moe_dp2"]
    assert got["aux"] == pytest.approx(float(z["aux"]), rel=1e-5, abs=1e-9)
    # the aux loss at DP = 2 is not the DP = 1 one: the routing differs
    assert float(z["aux"]) != float(z["aux_dp1"])
    assert got["y_err"] <= 1e-5 * got["y_scale"] + 1e-6


def test_straddling_int8_leaf_update_is_bit_for_bit(runs):
    from repro.train import optimizer as jopt
    got = runs[2]["straddle"]
    assert got["spec"] == ["data", "model"]
    # 384 of 768 columns a rank would cut block 1: the update moves the
    # model axis onto the leading dim, whole blocks on every rank
    assert got["update_spec"] == ["('data', 'model')", "None"]
    assert got["local_q"] == [4, 768]
    c = _straddle_case()
    cfg = jopt.OptConfig(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    p, m, v = jopt._adam_leaf(
        cfg, jnp.float32(c["lr"]), jnp.float32(c["scale"]),
        jnp.float32(c["bc1"]), jnp.float32(c["bc2"]), jnp.asarray(c["p"]),
        jnp.asarray(c["g"]), {"q": jnp.asarray(c["mq"]),
                              "s": jnp.asarray(c["ms"])},
        {"q": jnp.asarray(c["vq"]), "s": jnp.asarray(c["vs"])})
    want = {"p": p, "mq": m["q"], "ms": m["s"], "vq": v["q"], "vs": v["s"]}
    for k, x in want.items():
        assert got["out"][k] == hashlib.sha256(
            np.ascontiguousarray(np.asarray(x)).tobytes()).hexdigest(), k


def test_checkpoints_cross_mesh_shapes_and_packages(runs):
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.train import optimizer as jopt
    from repro.train import train_step as jtrain
    import repro.configs as JC
    saved = runs[4]["saved_22"]
    assert saved["step"] == 1
    assert runs[2]["restored_12"] == saved
    assert runs[1]["restored_11"] == saved
    assert runs[4]["resumed_41"] == {**saved, "mesh": [4, 1]}
    # the JAX package restores the (2, 2) save on one device
    cfg = dataclasses.replace(JC.get_smoke("deepseek_7b"),
                              param_dtype="float32")
    opt = jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20, eps=1e-3,
                         state_bits=8)
    like = {"state": jtrain.abstract_train_state(cfg, opt), "step_count": 0}
    tree, at = JManager(str(runs["dir"]), "port22").restore(like)
    assert at == 1 and tree["step_count"] == 1
    flat = jax.tree_util.tree_flatten_with_path(tree["state"])[0]
    got = {"/".join(k.key for k in path): hashlib.sha256(
        np.ascontiguousarray(np.asarray(x)).tobytes()).hexdigest()
        for path, x in flat}
    assert got == saved["digests"]
    # a JAX checkpoint restores at (2, 2): the reference's init, leaf for
    # leaf
    l4 = dataclasses.replace(JC.get_smoke("llama4_maverick_400b"),
                             param_dtype="float32")
    like = {"state": jtrain.abstract_train_state(
        l4, jopt.OptConfig(warmup_steps=1, total_steps=4)), "step_count": 0}
    tree, _ = JManager(str(runs["dir"] / "ref"), "llama4").restore(
        like, step=0)
    flat = jax.tree_util.tree_flatten_with_path(tree["state"])[0]
    want = {"/".join(k.key for k in path): hashlib.sha256(
        np.ascontiguousarray(np.asarray(x)).tobytes()).hexdigest()
        for path, x in flat}
    assert runs[4]["jax_init_digests"] == want


def test_sharded_init_is_the_unsharded_one(runs):
    assert runs[2]["init_equals_unsharded"] == [True, True]


def test_backward_outside_the_context_gives_the_same_grads(runs):
    assert runs[2]["backward_outside_ctx_equal"] is True


def test_launcher_on_two_ranks_gives_one_ranks_losses(runs):
    assert len(runs[2]["launcher"]) == 3
    np.testing.assert_allclose(runs[2]["launcher"], runs[1]["launcher"],
                               rtol=1e-3)


# ------------------------------------------------------------- in process

def test_microbatch_rows_are_the_reference_routing_groups():
    """Each rank's rows, gathered in rank order per microbatch, are the
    reference's microbatch rows, and its own share of microbatch i is the
    reference's routing group (i, rank)."""
    from repro.train import train_step as jtrain
    from repro_torch.data.pipeline import BatchShards
    G = 8
    batch = {"tokens": np.arange(G * 3).reshape(G, 3)}
    for n_micro, dp in ((1, 2), (2, 2), (2, 4), (4, 2)):
        micro = np.asarray(jtrain._split_micro(batch, n_micro)["tokens"])
        mb = G // n_micro
        ranks = [BatchShards(dp, r, n_micro).rows(G) for r in range(dp)]
        for i in range(n_micro):
            gathered = np.concatenate(
                [batch["tokens"][r[i * (mb // dp):(i + 1) * (mb // dp)]]
                 for r in ranks])
            np.testing.assert_array_equal(gathered, micro[i])
    # a microbatch that does not split over dp: every rank holds it whole
    shards = BatchShards(4, 1, 4)
    assert not shards.split(G)
    np.testing.assert_array_equal(shards.rows(G), np.arange(G))


def _job(kind, paged=False):
    import repro_torch.configs as C
    from repro_torch.core.runtime import JobSpec
    from repro_torch.models.config import ShapeConfig
    return JobSpec(C.get_smoke("deepseek_7b"),
                   ShapeConfig("s", kind, 16, 2), kind=kind, paged=paged)


def test_a_block_of_two_devices_without_a_process_group_raises():
    import torch.distributed as dist
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime
    assert not dist.is_initialized()
    grant = BlockGrant.new([(0, 0, 0), (0, 1, 0)], (1, 2), 60.0)
    with pytest.raises(RuntimeError, match="needs a process group of 2"):
        BlockRuntime(grant, _job("train"), devices=["cpu", "meta"])


@pytest.mark.parametrize("paged", [False, True])
def test_a_serve_block_of_two_devices_without_a_process_group_raises(paged):
    """As a train block's: serving on a mesh needs a process group."""
    import torch.distributed as dist
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime
    assert not dist.is_initialized()
    grant = BlockGrant.new([(0, 0, 0), (0, 1, 0)], (1, 2), 60.0)
    with pytest.raises(RuntimeError, match="needs a process group of 2"):
        BlockRuntime(grant, _job("serve", paged), devices=["cpu", "meta"])
