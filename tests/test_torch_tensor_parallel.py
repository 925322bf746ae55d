"""Tensor and expert parallelism over ``model`` (item 8d) on gloo ranks on
the CPU, against the JAX package's runs on the same mesh shapes.

The reference runs in three subprocesses with 4 forced host devices
each, at once (``REF``, parts "train", "train2" and "serve"): the train
part runs deepseek_7b (int8 moments, 2 microbatches) at (1, 2) and
(2, 2) and llama4_maverick_400b at (1, 2), (2, 2) and (1, 4), the
train2 part hubert_xlarge, pixtral_12b and deepseek_v2_236b at (1, 2),
3 steps each from its own init, saving every step; the serve part saves
its deepseek_7b
and llama4 serve blocks' inits, then prefills a 4 x 16 prompt and
decodes 3 greedy steps on the dense plane at (1, 2) and (2, 2)
(deepseek_7b) and (1, 2) (llama4).  The port's worlds of 4 and 2 gloo
ranks (``RANKS``: subprocesses joined through a ``FileStore`` in the
test's directory, each with ``torch.set_num_threads(1)``, a subprocess
timeout and a collective timeout; one spawn per world size) restore
those checkpoints as they land, run the same steps and traffic on the
same meshes and print one JSON line each, which the tests below read
through a module-scoped fixture.  Each rank records the shapes its model
code saw (the heads of every flash and decode attention call, the
experts of every batched expert product, the vocabulary of the logits
the loss read), the bytes ``shard_ctx.full`` brought over ``model`` in
a step and the bytes the model column's joins brought
(``shard_ctx.JOINED``), held to ``hlo_analysis.tp_traffic``'s count.

The configs are the smoke configs in fp32 (llama4's ``n_kv_heads = 2``
does not split 4 ways, so at (1, 4) its attention is gathered whole by
the plan's "heads" rule while its MLPs, experts and vocabulary compute
sharded).  Tolerances, those of ``tests/test_torch_multidevice.py`` and
``tests/test_torch_serve_blocks.py`` for the same runs:
* deepseek_7b: losses at rtol 1e-4 over 3 free-running steps, the grad
  norms step by step from the reference's checkpointed state at rtol
  1e-4, the params after 3 steps at atol 2e-3
  (``test_deepseek_int8_two_microbatches_vs_reference``);
* llama4: losses and grad norms at rtol 1e-4
  (``test_llama4_22_matches_the_reference_22``);
* hubert_xlarge (the frame stub kept whole, a vocab-parallel LM head),
  pixtral_12b (the patch stub kept whole, its GQA heads split) and
  deepseek_v2_236b (MLA's heads, its experts and shared expert split):
  losses and grad norms at rtol 1e-4 over 3 free-running steps,
  the params after 3 steps at atol 2e-3; besides, the loss and every
  grad of one step against the whole params on one device;
* the dense serve plane: greedy tokens equal, prefill logits within 1e-4
  of their largest magnitude;
* a serve context saved at (1, 2) (each rank's kv heads) and resumed at
  (2, 1) and at (1, 1): its whole leaves bit for bit, the next tokens
  the uninterrupted run's and the reference's;
* the three autograd Functions of ``shard_ctx`` on 2 ranks against one
  rank's whole-weight computation: values and gradients at rtol 1e-5;
* shapes seen and bytes brought over ``model``: exactly as
  ``plans.tp_layout`` says.
"""
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu")
TIMEOUT_S = 240

torch.set_num_threads(1)

COMMON = r'''
import dataclasses, json, os, sys, time
import numpy as np

DS, LL = "deepseek_7b", "llama4_maverick_400b"
PROMPT, GEN = 16, 3
HU, PX, V2 = "hubert_xlarge", "pixtral_12b", "deepseek_v2_236b"
TRAIN = {DS: ((1, 2), (2, 2)), LL: ((1, 2), (2, 2), (1, 4)),
         HU: ((1, 2),), PX: ((1, 2),), V2: ((1, 2),)}
# the reference's train runs, in two subprocesses at once
TRAIN_PARTS = {"train": (DS, LL), "train2": (HU, PX, V2)}
SERVE = {DS: ((1, 2), (2, 2)), LL: ((1, 2),)}


def fp32(C, arch):
    return dataclasses.replace(C.get_smoke(arch), param_dtype="float32")


def train_setup(C, Shape, Opt, arch):
    if arch == DS:
        return (Shape("t", "train", seq_len=16, global_batch=4, microbatch=2),
                Opt(lr=1e-2, warmup_steps=2, total_steps=20, eps=1e-3,
                    state_bits=8))
    return (Shape("t", "train", seq_len=32, global_batch=8, microbatch=2),
            Opt(warmup_steps=1, total_steps=4))


def serve_job(C, Job, Shape, arch, ns):
    return Job(fp32(C, arch), Shape("s", "serve", seq_len=PROMPT + GEN + 1,
                                    global_batch=4),
               kind="serve", ckpt_namespace=ns)


def prompt(C, Shape, pipeline, arch):
    return {k: v for k, v in pipeline.synthetic_batch(
        fp32(C, arch), Shape("p", "prefill", seq_len=PROMPT, global_batch=4),
        step=0, seed=0).items() if k != "labels"}
'''

REF = COMMON + r'''
import jax
import repro.configs as C
from repro.checkpoint.manager import CheckpointManager
from repro.core.block import BlockGrant
from repro.core.runtime import BlockRuntime, JobSpec
from repro.data import pipeline
from repro.models.config import ShapeConfig
from repro.sharding import ctx as shard_ctx, plans
from repro.train import optimizer as opt_lib, train_step as train_lib

root, part = sys.argv[1], sys.argv[2]
res = {}


def mesh_of(shape):
    devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return jax.sharding.Mesh(devs, ("data", "model"))


def train(arch, mesh_shape, n=3):
    cfg = fp32(C, arch)
    shape, opt_cfg = train_setup(C, ShapeConfig, opt_lib.OptConfig, arch)
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
    ns = f"{arch}_{mesh_shape[0]}{mesh_shape[1]}"
    mgr = CheckpointManager(root, ns, keep=10)
    mgr.save(0, {"state": state, "step_count": 0})
    hist = []
    for i in range(n):
        state, m = jstep(state, data.batch(i))
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        mgr.save(i + 1, {"state": state, "step_count": i + 1})
    open(os.path.join(root, f"done_{ns}"), "w").close()
    return hist


def block(arch, mesh):
    n = mesh[0] * mesh[1]
    grant = BlockGrant.new([(0, i, 0) for i in range(n)], mesh, 600.0)
    return BlockRuntime(grant, serve_job(C, JobSpec, ShapeConfig, arch,
                                         f"serve_{arch}"),
                        jax.devices()[:n], root)


def dense(arch, mesh):
    rt = block(arch, mesh)
    rt.restore(step=0)
    batch = prompt(C, ShapeConfig, pipeline, arch)
    cache0 = rt.cache
    rt.prefill(batch)
    logits, _ = rt._prefill_fn(rt.state["params"], batch, cache0)
    np.save(os.path.join(root, f"logits_{arch}_{mesh[0]}{mesh[1]}.npy"),
            np.asarray(logits))
    toks = [np.asarray(rt.token)[:, 0].tolist()]
    for _ in range(GEN):
        rt.step()
        toks.append(np.asarray(rt.token)[:, 0].tolist())
    return toks


if part in TRAIN_PARTS:
    for arch in TRAIN_PARTS[part]:
        for m in TRAIN[arch]:
            res[f"{arch}_{m[0]}{m[1]}"] = train(arch, m)
else:
    for arch in SERVE:
        rt = block(arch, (1, 1))
        rt.init_state()
        rt.save(async_=False)
    open(os.path.join(root, "done_serve_init"), "w").close()
    for arch, meshes in SERVE.items():
        for m in meshes:
            res[f"serve_{arch}_{m[0]}{m[1]}"] = dense(arch, m)
print("RESULT " + json.dumps(res))
'''

RANKS = COMMON + r'''
import hashlib, shutil
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, root, ref = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
from repro_torch import device as D
D.init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                   world_size=world, timeout_s=200)
import repro_torch.configs as C
from repro_torch.core.block import BlockGrant
from repro_torch.core.runtime import BlockRuntime, JobSpec, OffRankRuntime
from repro_torch.data import pipeline
from repro_torch.device import Chip
from repro_torch.kernels import ops
from repro_torch.launch.hlo_analysis import tp_traffic
from repro_torch.models import model as model_lib
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import flatten
from repro_torch.serve import serve_step
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.train import optimizer as opt_lib
from torch.distributed.tensor import DTensor

res = {}

# ---- what each rank's model code sees
SEEN = {"heads": set(), "experts": set(), "vocab": set()}


def tapped(fn, note):
    def wrapper(*a, **kw):
        note(*a)
        return fn(*a, **kw)
    return wrapper


ops.flash_attention = tapped(
    ops.flash_attention,
    lambda q, k, *_: SEEN["heads"].add((q.shape[1], k.shape[1])))
ops.decode_attention = tapped(
    ops.decode_attention,
    lambda q, k, *_: SEEN["heads"].add((q.shape[1], k.shape[1])))
torch.bmm = tapped(torch.bmm,
                   lambda a, *_: SEEN["experts"].add(a.shape[0]))
model_lib._xent = tapped(
    model_lib._xent, lambda logits, *_: SEEN["vocab"].add(logits.shape[-1]))


def observe():
    for v in SEEN.values():
        v.clear()
    shard_ctx.GATHERED["model_bytes"] = 0
    shard_ctx.JOINED["model_bytes"] = 0


def observed():
    return {**{k: sorted(v) for k, v in SEEN.items()},
            "model_bytes": shard_ctx.GATHERED["model_bytes"],
            "joined_bytes": shard_ctx.JOINED["model_bytes"]}


def traffic(cfg, shape, mesh):
    """``tp_traffic``'s computed bytes over ``model`` under 8d."""
    return tp_traffic(cfg, shape, {"data": mesh[0], "model": mesh[1]})["8d"]


def wait_for(path):
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > 200:
            raise TimeoutError(f"the reference wrote no {path}")
        time.sleep(0.2)


def whole(t):
    return t.detach().full_tensor() if isinstance(t, DTensor) else t.detach()


def digest(t):
    t = torch.as_tensor(whole(t)).contiguous()
    return hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


# ---- train blocks from the reference's checkpoints
def train_block(arch, mesh):
    shape, opt = train_setup(C, ShapeConfig, opt_lib.OptConfig, arch)
    ns = f"{arch}_{mesh[0]}{mesh[1]}"
    wait_for(os.path.join(ref, f"done_{ns}"))
    n = mesh[0] * mesh[1]
    job = JobSpec(fp32(C, arch), shape, kind="train", opt=opt, seed=0,
                  ckpt_namespace=ns)
    grant = BlockGrant.new([(0, i, 0) for i in range(n)], mesh, 600.0)
    return BlockRuntime(grant, job, devices=["cpu"] * n, ckpt_root=ref)


def train_block_of(arch, mesh):
    """A fresh train block of ``arch``'s smoke config in fp32 on the
    first ranks (16 x 4 tokens, one microbatch)."""
    n = mesh[0] * mesh[1]
    job = JobSpec(fp32(C, arch), ShapeConfig("t", "train", 16, 4, 1),
                  kind="train", opt=opt_lib.OptConfig(), seed=0)
    grant = BlockGrant.new([(0, i, 0) for i in range(n)], mesh, 600.0)
    return BlockRuntime(grant, job, devices=["cpu"] * n)


def one_step(rt):
    m = rt.step()
    return [m["loss"], m["grad_norm"]]


def train(arch, mesh):
    rt = train_block(arch, mesh)
    out = {"tp": rt.tp.summary()}
    if arch == DS:          # grad norms from the reference's state
        forced = []
        for k in range(3):
            rt.restore(step=k)
            forced.append(one_step(rt))
        out["forced"] = forced
    rt.restore(step=0)
    observe()
    free = [one_step(rt)]
    out["seen"] = observed()
    out["want_bytes"] = rt.tp.step_bytes(
        rt.job.shape.microbatch, remat=rt.job.cfg.remat != "none")
    out["want_traffic"] = traffic(rt.job.cfg, rt.job.shape, mesh)
    free += [one_step(rt) for _ in range(2)]
    out["free"] = free
    arrs = {p: whole(t).float().numpy()
            for p, t in flatten(rt.state["params"])}
    if rank == 0:
        np.savez(os.path.join(root, f"{arch}_{mesh[0]}{mesh[1]}.npz"),
                 **arrs)
    rt.release()
    return out


# ---- the dense serve plane from the reference's serve inits
def job(arch, ns=None):
    return serve_job(C, JobSpec, ShapeConfig, arch, ns or f"serve_{arch}")


def runtime(j, mesh, ranks):
    grant = BlockGrant.new([(0, r, 0) for r in ranks], mesh, 600.0)
    devices = [Chip(r, "cpu") for r in ranks]
    cls = BlockRuntime if rank in ranks else OffRankRuntime
    return cls(grant, j, devices, root)


def rebuild(old, mesh, ranks):
    grant = BlockGrant.new([(0, r, 0) for r in ranks], mesh, 600.0)
    devices = [Chip(r, "cpu") for r in ranks]
    cls = BlockRuntime if rank in ranks else OffRankRuntime
    return cls.rebuild(old, grant, devices, root)


def tokens(rt):
    return rt.token[:, 0].tolist()


def ctx_digests(rt):
    return {p: digest(t) for p, t in flatten(rt._decode_ctx())}


def serve(arch, mesh, gen=GEN, j=None, keep=False):
    rt = runtime(j or job(arch), mesh, list(range(mesh[0] * mesh[1])))
    rt.restore(step=0)
    step, box = serve_step.make_prefill_step(rt.job.cfg), {}

    def fn(params, batch, cache):
        logits, cache = step(params, batch, cache)
        box["logits"] = shard_ctx.gather_rows(logits)
        return logits, cache
    rt._prefill_fn = fn
    observe()
    rt.prefill(prompt(C, ShapeConfig, pipeline, arch))
    out = {"prefill_seen": observed(), "want_bytes": rt.tp.step_bytes(1),
           "want_traffic": {
               "prefill": traffic(rt.job.cfg, ShapeConfig(
                   "p", "prefill", PROMPT, 4), mesh),
               "decode": traffic(rt.job.cfg, ShapeConfig(
                   "d", "decode", 1, 4), mesh)}}
    if rank == 0:
        np.save(os.path.join(root, f"logits_{arch}_{mesh[0]}{mesh[1]}.npy"),
                box["logits"].numpy())
    toks = [tokens(rt)]
    for i in range(gen):
        observe()
        rt.step()
        if i == 0:
            out["decode_seen"] = observed()
        toks.append(tokens(rt))
    out.update(tokens=toks, tp=rt.tp.summary(),
               cache_heads=sorted({leaf.shape[-2] for path, leaf in
                                   flatten(rt.cache)
                                   if path.split("/")[-1] in ("k", "v")}))
    if not keep:
        rt.release()
    return out, rt


def functions_against_one_rank():
    """copy_in, reduce_out and gather_out on a (1, 2) mesh: a column- then
    row-parallel product and a gathered one, values and gradients
    against the whole weights on one rank."""
    from repro_torch.launch.mesh import make_block_mesh
    mesh = make_block_mesh(range(2), (1, 2))
    ctx = shard_ctx.ShardCtx(mesh, ("data",), "model")
    g = torch.Generator().manual_seed(0)
    x, w1, w2, w3, c = (torch.randn(s, generator=g, dtype=torch.float64)
                        for s in ((3, 8), (8, 6), (6, 8), (8, 4), (3, 8)))

    def loss(x, w1, w2, w3, sharded):
        if sharded:
            y = shard_ctx.reduce_out(
                torch.tanh(shard_ctx.copy_in(x) @ w1) @ w2)
            h = shard_ctx.gather_out(shard_ctx.copy_in(x) @ w3, -1)
        else:
            y, h = torch.tanh(x @ w1) @ w2, x @ w3
        return (y * c).sum() + (h * c[:, :4] ** 2).sum()

    leaves = [t.clone().requires_grad_() for t in (x, w1, w2, w3)]
    want = loss(*leaves, False)
    gw = torch.autograd.grad(want, leaves)
    r = rank
    mine = [x, w1[:, 3 * r:3 * r + 3], w2[3 * r:3 * r + 3],
            w3[:, 2 * r:2 * r + 2]]
    mine = [t.clone().requires_grad_() for t in mine]
    with shard_ctx.use(ctx):
        got = loss(*mine, True)
    gm = torch.autograd.grad(got, mine)
    pairs = [(got, want), (gm[0], gw[0]), (gm[1], gw[1][:, 3 * r:3 * r + 3]),
             (gm[2], gw[2][3 * r:3 * r + 3]), (gm[3], gw[3][:, 2 * r:2 * r + 2])]
    return max(float(((a - b).abs() / b.abs()).max()) for a, b in pairs)


# ---- the runs
for arch, meshes in TRAIN.items():
    for m in meshes:
        if m[0] * m[1] == world:
            res[f"train_{arch}_{m[0]}{m[1]}"] = train(arch, m)
wait_for(os.path.join(ref, "done_serve_init"))
if rank == 0:
    for arch in SERVE:
        shutil.copytree(os.path.join(ref, f"serve_{arch}"),
                        os.path.join(root, f"serve_{arch}"))
    shutil.copytree(os.path.join(ref, f"serve_{DS}"),
                    os.path.join(root, "tp_ckpt"))
dist.barrier()
for arch, meshes in SERVE.items():
    for m in meshes:
        if m[0] * m[1] == world:
            res[f"serve_{arch}_{m[0]}{m[1]}"], _ = serve(arch, m)
if world == 2:
    res["functions_rel_err"] = functions_against_one_rank()
    # the encoder, the VLM and MLA with shared and routed experts at
    # (1, 2): the loss and every grad against the whole params on one
    # device
    from repro_torch.train import train_step as train_lib
    for arch in ("hubert_xlarge", "pixtral_12b", "deepseek_v2_236b"):
        rt = train_block_of(arch, (1, 2))
        rt.init_state()
        batch = rt.data.batch(0)
        with shard_ctx.use(rt.ctx):
            loss, grads = train_lib.value_and_grad(rt.state["params"],
                                                   rt.job.cfg, batch)
        plain = {p: whole(t).clone().requires_grad_()
                 for p, t in flatten(rt.state["params"])}
        from repro_torch.models.transformer import unflatten
        loss1, grads1 = train_lib.value_and_grad(unflatten(plain.items()),
                                                 rt.job.cfg, batch)
        g1 = dict(flatten(grads1))
        res[f"one_device_{arch}"] = {
            "tp": rt.tp.summary(),
            "loss": [float(loss), float(loss1)],
            "grads_within": all(torch.allclose(whole(g), g1[p], rtol=1e-4,
                                               atol=1e-6)
                                for p, g in flatten(grads))}
        rt.release()
    # a decode context saved at (1, 2), each rank holding its kv heads,
    # resumed at (2, 1) and at (1, 1)
    out, rt = serve(DS, (1, 2), gen=2, j=job(DS, "tp_ckpt"), keep=True)
    seen = {"local_heads": out["cache_heads"], "saved": ctx_digests(rt),
            "step": rt.step_count}
    rt.suspend()
    for name, mesh, ranks in (("resumed_21", (2, 1), [0, 1]),
                              ("resumed_11", (1, 1), [1])):
        rt = rebuild(rt, mesh, ranks)
        if rank in ranks:
            seen[name] = {"ctx": ctx_digests(rt), "step": rt.step_count,
                          "heads": sorted({leaf.shape[-2] for path, leaf in
                                           flatten(rt.cache)
                                           if path.endswith(("k", "v"))})}
            rt.step()
            seen[name]["next"] = tokens(rt)
    rt.release()
    res["ckpt"] = seen
print("RESULT " + json.dumps({"rank": rank, **res}))
dist.destroy_process_group()
'''


def _collect(procs, deadline):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(5, deadline - time.time())))
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"process failed:\n{so[-2000:]}\n" \
                                  f"{se[-6000:]}"
    res = []
    for so, _ in outs:
        line = [x for x in so.splitlines() if x.startswith("RESULT ")]
        res.append(json.loads(line[-1][len("RESULT "):]))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": the reference's results (both parts), 4, 2: each port
    world's lines by rank, "dir": the test's directory}."""
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    ref = tmp / "ref"
    ref.mkdir()
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    deadline = time.time() + TIMEOUT_S
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF, str(ref), part], cwd=str(tmp),
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("train", "train2", "serve")]
    try:
        worlds = {}
        for world in (4, 2):
            root = tmp / f"port{world}"
            root.mkdir()
            worlds[world] = [subprocess.Popen(
                [sys.executable, str(script), str(r), str(world),
                 str(tmp / f"store{world}"), str(root), str(ref)],
                cwd=str(root), env=ENV, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True) for r in range(world)]
        out = {w: _collect(ps, deadline) for w, ps in worlds.items()}
        a, b, c = _collect(refs, deadline)
    finally:
        for p in refs:
            p.kill()
    out["ref"] = {**a, **b, **c}
    out["dir"] = tmp
    return out


def _first(lines, key):
    """``key`` as the first rank that has it has it, after checking that
    every rank holding it holds the same."""
    vals = [r[key] for r in lines if r.get(key) is not None]
    assert vals, key
    assert all(v == vals[0] for v in vals), (key, vals)
    return vals[0]


def _fp32(arch):
    import repro_torch.configs as C
    return dataclasses.replace(C.get_smoke(arch), param_dtype="float32")


def _layout(arch, mesh):
    from repro_torch.sharding import plans
    return plans.tp_layout(_fp32(arch), {"data": int(mesh[0]),
                                         "model": int(mesh[1])})


TRAIN_CASES = [("deepseek_7b", "12", 2), ("deepseek_7b", "22", 4),
               ("llama4_maverick_400b", "12", 2),
               ("llama4_maverick_400b", "22", 4),
               ("llama4_maverick_400b", "14", 4)]
TRAIN_IDS = [f"{a}-{m}" for a, m, _ in TRAIN_CASES]
# the encoder (the frame stub kept whole, a vocab-parallel LM head), the
# VLM (the patch stub kept whole, GQA 4 / 2 heads split) and MLA (its
# heads split) with its experts and shared expert split
OTHER_CASES = [("hubert_xlarge", "12", 2), ("pixtral_12b", "12", 2),
               ("deepseek_v2_236b", "12", 2)]


@pytest.mark.parametrize("arch,mesh,world", TRAIN_CASES + OTHER_CASES,
                         ids=TRAIN_IDS + [f"{a}-{m}" for a, m, _ in
                                          OTHER_CASES])
def test_train_steps_match_the_reference_on_the_same_mesh(runs, arch, mesh,
                                                          world):
    """Losses and grad norms at rtol 1e-4 (deepseek_7b's int8 grad norms
    step by step from the reference's state), the params after 3 steps
    at atol 2e-3 but llama4's, as ``tests/test_torch_multidevice.py``
    holds these runs."""
    got = _first(runs[world], f"train_{arch}_{mesh}")
    want = np.asarray(runs["ref"][f"{arch}_{mesh}"])
    if arch == "deepseek_7b":
        np.testing.assert_allclose(np.asarray(got["free"])[:, 0], want[:, 0],
                                   rtol=1e-4)
        np.testing.assert_allclose(np.asarray(got["forced"]), want,
                                   rtol=1e-4)
    else:
        np.testing.assert_allclose(got["free"], want, rtol=1e-4)
    if arch == "llama4_maverick_400b":
        return
    import jax
    import repro.configs as JC
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.train import optimizer as jopt
    from repro.train import train_step as jtrain
    cfg = dataclasses.replace(JC.get_smoke(arch), param_dtype="float32")
    opt = (jopt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=20, eps=1e-3,
                          state_bits=8) if arch == "deepseek_7b"
           else jopt.OptConfig(warmup_steps=1, total_steps=4))
    like = {"state": jtrain.abstract_train_state(cfg, opt), "step_count": 0}
    ref, at = JManager(str(runs["dir"] / "ref"), f"{arch}_{mesh}").restore(
        like, step=3)
    assert at == 3
    mine = np.load(runs["dir"] / f"port{world}" / f"{arch}_{mesh}.npz")
    flat = jax.tree_util.tree_flatten_with_path(ref["state"]["params"])[0]
    assert len(flat) == len(mine.files)
    for path, leaf in flat:
        name = "/".join(k.key for k in path)
        np.testing.assert_allclose(mine[name], np.asarray(leaf), atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("arch,mesh,world", TRAIN_CASES, ids=TRAIN_IDS)
def test_each_rank_computes_its_share_and_gathers_nothing_of_it(
        runs, arch, mesh, world):
    """Flash, the expert products and the train logits see 1/M of the
    heads, experts and vocabulary, as ``tp_layout`` says (the whole
    heads where its "heads" rule keeps llama4's attention at (1, 4)),
    and ``full`` brings over ``model`` exactly the bytes of the leaves it
    keeps whole, every rank alike."""
    got = _first(runs[world], f"train_{arch}_{mesh}")
    lay = _layout(arch, mesh)
    cfg = _fp32(arch)
    M = int(mesh[1])
    assert got["tp"] == lay.summary()
    seen = got["seen"]
    assert seen["heads"] == [list(lay.heads)]
    assert seen["vocab"] == [cfg.vocab_size // M]
    if cfg.moe is not None:
        assert seen["experts"] == [cfg.moe.n_experts // M]
    assert seen["model_bytes"] == got["want_bytes"] == lay.step_bytes(
        2, remat=True)
    # the joins brought what ``tp_traffic`` computes beside the gathers
    assert seen["joined_bytes"] > 0
    assert seen["model_bytes"] + seen["joined_bytes"] == got["want_traffic"]
    if (arch, mesh) == ("llama4_maverick_400b", "14"):
        assert "attn" not in lay.kinds and lay.kept == ("heads: 4/2 % 4",)
        assert lay.heads == (4, 2) and got["want_bytes"] > 0
        # the attention leaves, 3/4 of each brought a forward, twice a
        # microbatch under remat, 2 microbatches
        attn = sum(t.numel() * t.element_size() for p, t in _flat_meta(cfg)
                   if "/attn/" in p)
        assert got["want_bytes"] == 2 * 2 * attn * 3 // 4
    else:
        assert lay.kinds >= {"attn", "mlp", "vocab"} and lay.kept == ()
        assert got["want_bytes"] == 0


def _flat_meta(cfg):
    from repro_torch.models import model
    from repro_torch.models.transformer import flatten
    return flatten(model.abstract_params(cfg))


SERVE_CASES = [("deepseek_7b", "12", 2), ("deepseek_7b", "22", 4),
               ("llama4_maverick_400b", "12", 2)]
SERVE_IDS = [f"{a}-{m}" for a, m, _ in SERVE_CASES]


@pytest.mark.parametrize("arch,mesh,world", SERVE_CASES, ids=SERVE_IDS)
def test_dense_serve_plane_matches_the_reference(runs, arch, mesh, world):
    got = _first(runs[world], f"serve_{arch}_{mesh}")
    assert got["tokens"] == runs["ref"][f"serve_{arch}_{mesh}"]
    mine = np.load(runs["dir"] / f"port{world}" / f"logits_{arch}_{mesh}.npy")
    want = np.load(runs["dir"] / "ref" / f"logits_{arch}_{mesh}.npy")
    assert mine.shape == want.shape == (4, _fp32(arch).vocab_size)
    np.testing.assert_allclose(mine, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("arch,mesh,world", SERVE_CASES, ids=SERVE_IDS)
def test_dense_serve_plane_holds_and_computes_its_heads(runs, arch, mesh,
                                                        world):
    got = _first(runs[world], f"serve_{arch}_{mesh}")
    lay = _layout(arch, mesh)
    a = _fp32(arch).attention
    M = int(mesh[1])
    assert got["tp"] == lay.summary() and lay.computes("attn")
    # every cache leaf holds Hkv / M heads
    assert got["cache_heads"] == [a.n_kv_heads // M]
    for phase in ("prefill", "decode"):
        seen = got[f"{phase}_seen"]
        assert seen["heads"] == [[a.n_heads // M, a.n_kv_heads // M]]
        assert seen["model_bytes"] == got["want_bytes"] == 0
        # the joins brought what ``tp_traffic`` computes
        assert 0 < seen["joined_bytes"] == got["want_traffic"][phase]


def test_a_context_saved_at_12_resumes_at_21_and_11(runs):
    lines = runs[2]
    ck = [r["ckpt"] for r in lines]
    saved = _first(ck, "saved")
    assert _first(ck, "local_heads") == [2] and _first(ck, "step") == 2
    want_next = runs["ref"]["serve_deepseek_7b_12"][3]
    assert want_next == _first(lines, "serve_deepseek_7b_12")["tokens"][3]
    r21 = _first(ck, "resumed_21")
    assert r21 == {"ctx": saved, "step": 2, "heads": [4], "next": want_next}
    r11 = lines[1]["ckpt"]["resumed_11"]
    assert r11 == {"ctx": saved, "step": 2, "heads": [4], "next": want_next}
    assert "resumed_11" not in lines[0]["ckpt"]


def test_a_context_saved_at_12_is_the_references_format(runs):
    """The (1, 2) save holds whole leaves: the JAX package restores it,
    its cache leaves of every kv head bit for bit the saved ones."""
    import jax
    import repro.configs as JC
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.models import model as jmodel
    from repro.serve import serve_step as jserve
    cfg = dataclasses.replace(JC.get_smoke("deepseek_7b"),
                              param_dtype="float32")
    like = {"state": {"params": jmodel.abstract_params(cfg)},
            "step_count": 0,
            "decode": {"cache": jserve.abstract_cache(cfg, 4, 20),
                       "token": jax.ShapeDtypeStruct((4, 1), np.int32),
                       "cache_len": jax.ShapeDtypeStruct((), np.int32)}}
    tree, at = JManager(str(runs["dir"] / "port2"), "tp_ckpt").restore(
        like, step=2)
    assert at == 2 and int(tree["decode"]["cache_len"]) == 16 + 2
    saved = _first([r["ckpt"] for r in runs[2]], "saved")
    for k in ("k", "v"):
        leaf = np.ascontiguousarray(np.asarray(tree["decode"]["cache"][k]))
        assert leaf.shape[-2] == cfg.attention.n_kv_heads
        assert hashlib.sha256(leaf.tobytes()).hexdigest() == \
            saved[f"cache/{k}"]


@pytest.mark.parametrize("arch", ["hubert_xlarge", "pixtral_12b",
                                  "deepseek_v2_236b"])
def test_other_families_at_12_give_one_devices_loss_and_grads(runs, arch):
    """The encoder (the frame stub kept whole, a vocab-parallel LM head),
    the VLM (the patch stub kept whole, GQA 4 / 2 heads split) and MLA
    (its heads split) with its experts and shared expert split: the loss at
    rtol 1e-5 and every grad at rtol 1e-4, atol 1e-6 against the whole
    params on one device, as ``tests/test_torch_multidevice.py`` holds
    hubert on two ranks against one."""
    got = _first(runs[2], f"one_device_{arch}")
    assert got["tp"] == _layout(arch, "12").summary()
    assert got["loss"][0] == pytest.approx(got["loss"][1], rel=1e-5)
    assert got["grads_within"]


def test_the_autograd_functions_match_one_rank_whole(runs):
    errs = [r["functions_rel_err"] for r in runs[2]]
    assert len(errs) == 2 and max(errs) <= 1e-5


# ------------------------------------------------------------- in process

def test_llama4_full_width_group_on_eight_model_ranks():
    """llama4_maverick_400b at full width on a (1, 8) mesh, on meta
    tensors: every part divides by 8 (40 / 8 heads), so a rank gathers
    1/8 of a group's leaves but its norms and router: ~4.1 GB of the
    ~33 GB group in bf16 that 8a gathers whole, and nothing over
    ``model``."""
    import repro_torch.configs as C
    from repro_torch.sharding import plans
    cfg = C.get("llama4_maverick_400b")
    lay = plans.tp_layout(cfg, {"data": 1, "model": 8})
    assert lay.kinds == {"attn", "mlp", "shared", "experts", "vocab"}
    assert lay.heads == (5, 1) and lay.kept == ()
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    H, Hkv, hd = 40, 8, 128
    attn = d * H * hd * 2 + d * Hkv * hd * 2
    sharded = 2 * (E * 3 * d * cfg.moe.d_ff_expert + 2 * attn + 2 * 3 * d * ff)
    whole_rest = 4 * d * 2 + d * E * 4      # four norm scales, the router
    assert lay.group_bytes_whole == sharded + whole_rest
    assert lay.group_bytes == sharded // 8 + whole_rest
    assert 4.0e9 < lay.group_bytes < 4.2e9
    assert 32.9e9 < lay.group_bytes_whole < 33.0e9
    assert lay.step_bytes(4, remat=True) == 0


def test_the_layout_rule_names_every_part_it_keeps():
    import repro_torch.configs as C
    from repro_torch.sharding import plans
    mesh = {"data": 1, "model": 2}
    kept = {a: plans.tp_layout(C.get_smoke(a), mesh).kept
            for a in ("deepseek_v2_236b", "zamba2_2p7b", "xlstm_350m",
                      "hubert_xlarge", "pixtral_12b")}
    assert kept == {"deepseek_v2_236b": (),
                    "zamba2_2p7b": (),
                    "xlstm_350m": ("slstm_ff: 85 % 2",),
                    "hubert_xlarge": ("frontend: frame",),
                    "pixtral_12b": ("frontend: patch",)}
    # the xLSTM computes its heads and vocabulary sharded (the smoke
    # config's 2 heads at M = 2); its sLSTM's feed-forward, 85 wide,
    # stays whole by the named rule
    # the hybrid computes its Mamba2 heads sharded where H divides by M
    # (zamba2's 80 heads at M = 16), else keeps them whole by the named
    # rule (M = 32: its attention heads, MLP width and vocabulary still
    # divide)
    zamba = C.get("zamba2_2p7b")
    z16 = plans.tp_layout(zamba, {"data": 1, "model": 16})
    assert z16.kinds == {"attn", "mlp", "vocab", "mamba"} and z16.kept == ()
    assert z16.heads == (2, 2) and z16.partial
    z32 = plans.tp_layout(zamba, {"data": 1, "model": 32})
    assert z32.kept == ("mamba: 80 % 32",) and "mamba" not in z32.kinds
    assert not z32.partial
    paged = plans.tp_layout(C.get_smoke("deepseek_7b"), mesh, paged=True)
    assert paged.kept == ("paged",) and not paged.kinds
    v2 = plans.tp_layout(C.get_smoke("deepseek_v2_236b"), mesh)
    assert v2.kinds == {"attn", "experts", "shared", "vocab"}
    # MLA's heads compute sharded: every leaf the plan puts on model is
    # the rank's shard, so nothing is brought over model; its
    # down-projections and norms, replicated over model, are gathered
    # whole with their gradients summed over the column
    assert v2.bytes_groups == 0
    assert v2.partial == {f"layers/attn/{n}" for n in plans.MLA_WHOLE}
    # at M = 1 every part computes "sharded", on its whole width
    one = plans.tp_layout(C.get_smoke("deepseek_7b"), {"data": 1, "model": 1})
    assert one.kinds == {"attn", "mlp", "vocab"} and one.heads == (4, 4)
    assert one.step_bytes(2, remat=True) == 0


def test_cache_layouts_put_kv_heads_over_model_where_attention_is_tp():
    """The kv heads of ``k``/``v`` over ``model`` where the attention
    computes sharded (the hybrid's shared attention now too), the
    Mamba2 ``ssm`` state's heads where Mamba2 does, and every leaf's
    local shape ``init_cache``'s with the same splits; the ``conv``
    state's layout is its whole leaf (the checkpoint's), while a rank
    holds its heads' ``x`` channels and the whole B and C."""
    import repro_torch.configs as C
    from repro_torch.models import model
    from repro_torch.models.ssm import mamba_columns
    from repro_torch.models.transformer import flatten
    from repro_torch.sharding import plans
    from torch.distributed.tensor import Replicate, Shard
    mesh = {"data": 2, "model": 2}
    for arch, heads in (("deepseek_7b", True),
                        ("llama4_maverick_400b", True),
                        ("deepseek_v2_236b", False), ("zamba2_2p7b", True)):
        cfg = C.get_smoke(arch)
        lay = plans.tp_layout(cfg, mesh)
        mamba = lay.computes("mamba")
        assert mamba == (arch == "zamba2_2p7b")
        cache = model.init_cache(cfg, 4, 8, "meta")
        lays = dict(flatten(plans.cache_layouts(cache, mesh, tp=lay)))
        local = dict(flatten(model.init_cache(
            cfg, 2, 8, "meta", kv_split=2 if heads else 1,
            mamba_split=2 if mamba else 1)))
        for path, leaf in flatten(cache):
            name = path.split("/")[-1]
            want = Replicate()
            if heads and name in ("k", "v"):
                want = Shard(leaf.ndim - 2)
            elif mamba and name == "ssm":
                want = Shard(leaf.ndim - 3)
            assert lays[path].placements[1] == want, (arch, path)
            shape = list(leaf.shape)
            for pl, n in zip(lays[path].placements, mesh.values()):
                if isinstance(pl, Shard):
                    shape[pl.dim] //= n
            if mamba and name == "conv":
                di, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
                ch = mamba_columns(cfg.ssm, cfg.d_model, 2, 1)[1]
                assert len(ch) == di // 2 + 2 * N == shape[-1] - di // 2
                shape[-1] = len(ch)
            assert shape == list(local[path].shape), (arch, path)


def test_computed_traffic_over_model_a_step():
    """``hlo_analysis.tp_traffic`` (computed, not measured) at full width:
    deepseek_7b's train step under 8a gathers (M - 1) / M of every
    model-sharded leaf, the groups twice under remat; under 8d nothing
    of the params, only the joins' activations (their count held to what
    the joins bring on gloo ranks above), a decode step's a few MB; at
    M = 1 nothing."""
    import repro_torch.configs as C
    from repro_torch.launch.hlo_analysis import tp_traffic
    from repro_torch.models.config import ShapeConfig
    cfg = C.get("deepseek_7b")
    d, ff, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_layers
    groups = L * (4 * d * d + 3 * d * ff) * 2         # bf16, every layer
    top = 2 * V * d * 2                                # embed and head
    train = ShapeConfig("t", "train", 2048, 2, 1)
    decode = ShapeConfig("d", "decode", 1, 4)
    for M in (2, 4):
        mesh = {"data": 1, "model": M}
        got = tp_traffic(cfg, train, mesh)
        assert got["8a"] == (top + 2 * groups) * (M - 1) // M
        assert 0 < got["8d"] < got["8a"]
        dec = tp_traffic(cfg, decode, mesh)
        assert dec["8a"] == (top + groups) * (M - 1) // M
        assert dec["8d"] < 4e6 < 6e9 < dec["8a"]
    one = tp_traffic(cfg, train, {"data": 1, "model": 1})
    assert one == {"8a": 0, "8d": 0}
