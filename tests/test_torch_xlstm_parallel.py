"""The xLSTM family over ``model`` (item 8g, last part) on gloo ranks on
the CPU, against the JAX package's runs on the same mesh shapes.

Three configs (``CFGS``), each xlstm_350m's smoke config in fp32: "a"
with 4 heads (d_model 64: the sLSTM's feed-forward is 85 wide, which no
M > 1 divides, so every rank computes it whole, rule "slstm_ff"); "b"
with 4 heads at d_model 48 (a feed-forward of 64, computed sharded at
M = 2 and 4); "c" with the smoke config's own 2 heads, run at (1, 4),
where the layout keeps the heads whole by its named rule ("xlstm: heads
2 % 4") and still splits the vocabulary.

The reference runs in two subprocesses with 4 forced host devices each,
at once (``REF``, parts "train" and "serve"): the train part runs "a"
at (1, 2), (2, 2) and (1, 4), "b" at (1, 2) and (1, 4) and "c" at
(1, 4), 3 steps each from its own init, saving every step; the serve
part saves a serve block's init for each config, then prefills a
4 x 16 prompt and decodes 3 greedy steps on the dense plane (``SERVE``:
"a" at its three meshes, "b" and "c" at (1, 4)).  The port's worlds of
4 and 2 gloo ranks (``RANKS``, one spawn per world size, as
``tests/test_torch_hybrid_parallel.py``) restore those checkpoints as
they land, run the same steps on the same meshes and print one JSON
line each.  Both sides take the sLSTM's bf16 stacking out (the
reference module's ``jnp`` seen through a stand-in whose ``bfloat16`` is
float32, the port's ``ssm.SLSTM_STACK_DTYPE``), as
``tests/test_torch_xlstm.py``'s ``unround`` does and says why: with it
the two frameworks' last-bit differences become one-bf16-step ones.

Held, with ``tests/test_torch_hybrid_parallel.py``'s tolerances:
* train: losses and grad norms at rtol 1e-4 over 3 free-running steps
  at ``tests/test_torch_xlstm.py``'s trajectory settings (lr 3e-3,
  Adam's eps at 1e-3), the params after 3 steps at atol 2e-3.  With
  eps at 1e-8 Adam's first updates turn the last-bit differences of
  near-zero gradients into whole steps: the port's one-device run and
  its (1, 2) run, whose first grad norms agree to 1e-7, part by 2e-4
  in the third step's (read on config "a"), as the reference does
  against itself from params one ulp apart;
* serve: greedy tokens equal, prefill and every decode step's logits
  within 1e-4 of their largest magnitude (the whole batch's rows,
  gathered over ``data`` at (2, 2));
* what each rank computes: the mLSTM's scan and decode step and the
  sLSTM's recurrence see H / M heads (H where the heads are kept
  whole), a rank takes all of ``xm`` and its heads' ``z`` of ``w_up``,
  its heads' ``i`` and ``f`` of ``w_if`` and its heads' columns of each
  of ``w_gates``' four gates, the conv runs on all of ``inner``, the
  loss sees V / M of the vocabulary; the decode states hold H / M
  heads and the conv tail all of ``inner``; the bytes ``full`` brings
  over ``model`` and the joins' bytes as ``plans.TPLayout`` and
  ``hlo_analysis.tp_traffic`` compute them;
* a context saved at (1, 2) (each rank its heads' rows of the states)
  resumes at (1, 1): its whole leaves bit for bit, the next token the
  uninterrupted run's; the JAX package restores the saved files, every
  leaf bit for bit (the fp32 conv tail as the reference's bf16 restore
  target rounds it);
* in process: the layout rule on xlstm_350m at M = 1 to 16, the
  columns a rank takes, the cache layouts, the dry run's xlstm cells;
  ``chip_smoke.py``'s ``xlstm_sharded`` at smoke size.
"""
import dataclasses
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
TIMEOUT_S = 300

torch.set_num_threads(1)

COMMON = r'''
import dataclasses, json, os, sys, time
import numpy as np

XL = "xlstm_350m"
#: config: (d_model, n_heads)
CFGS = {"a": (64, 4), "b": (48, 4), "c": (64, 2)}
TRAIN = (("a", (1, 2)), ("a", (2, 2)), ("a", (1, 4)), ("b", (1, 2)),
         ("b", (1, 4)), ("c", (1, 4)))
SERVE = (("a", (1, 2)), ("a", (2, 2)), ("a", (1, 4)), ("b", (1, 4)),
         ("c", (1, 4)))
PROMPT, GEN = 16, 3


def cfg_of(C, name):
    d, heads = CFGS[name]
    c = C.get_smoke(XL)
    return dataclasses.replace(c, param_dtype="float32", d_model=d,
                               xlstm=dataclasses.replace(c.xlstm,
                                                         n_heads=heads))


def tag(name, mesh):
    return f"{name}{mesh[0]}{mesh[1]}"


def train_setup(Shape, Opt):
    return (Shape("t", "train", seq_len=32, global_batch=4, microbatch=2),
            Opt(lr=3e-3, warmup_steps=2, total_steps=20, eps=1e-3))


def serve_job(C, Job, Shape, name, ns=None):
    return Job(cfg_of(C, name), Shape("s", "serve", seq_len=PROMPT + GEN + 1,
                                      global_batch=4),
               kind="serve", ckpt_namespace=ns or f"serve_{name}")


def prompt(C, Shape, pipeline, name):
    return {k: v for k, v in pipeline.synthetic_batch(
        cfg_of(C, name), Shape("p", "prefill", seq_len=PROMPT,
                               global_batch=4),
        step=0, seed=0).items() if k != "labels"}
'''

REF = COMMON + r'''
import jax
import jax.numpy as jnp
import repro.configs as C
from repro.checkpoint.manager import CheckpointManager
from repro.core.block import BlockGrant
from repro.core.runtime import BlockRuntime, JobSpec
from repro.data import pipeline
from repro.models import model as model_lib
from repro.models import ssm as ssm_lib
from repro.models.config import ShapeConfig
from repro.sharding import ctx as shard_ctx, plans
from repro.train import optimizer as opt_lib, train_step as train_lib


class _JnpStackingF32:
    """``jax.numpy`` with ``bfloat16`` read as float32."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


ssm_lib.jnp = _JnpStackingF32()
root, part = sys.argv[1], sys.argv[2]
res = {}


def mesh_of(shape):
    devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return jax.sharding.Mesh(devs, ("data", "model"))


def train(name, mesh_shape, n=3):
    cfg = cfg_of(C, name)
    shape, opt_cfg = train_setup(ShapeConfig, opt_lib.OptConfig)
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
    ns = f"train_{tag(name, mesh_shape)}"
    mgr = CheckpointManager(root, ns, keep=10)
    mgr.save(0, {"state": state, "step_count": 0})
    hist = []
    for i in range(n):
        state, m = jstep(state, data.batch(i))
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        mgr.save(i + 1, {"state": state, "step_count": i + 1})
    open(os.path.join(root, f"done_{ns}"), "w").close()
    return hist


def serve(name, mesh):
    """The reference's serve block on ``mesh`` from its saved init: the
    prefill's logits and tokens, then ``GEN`` decode steps, each the
    block's own decode (``model.decode_step`` and the argmax, jitted
    under the block's context) with its logits kept."""
    job = serve_job(C, JobSpec, ShapeConfig, name)
    n = mesh[0] * mesh[1]
    grant = BlockGrant.new([(0, i, 0) for i in range(n)], mesh, 600.0)
    rt = BlockRuntime(grant, job, jax.devices()[:n], root)
    rt.restore(step=0)
    batch = prompt(C, ShapeConfig, pipeline, name)
    cache0 = rt.cache
    rt.prefill(batch)
    logits, _ = rt._prefill_fn(rt.state["params"], batch, cache0)
    rows = [np.asarray(logits)]
    cfg, ctx = job.cfg, rt.ctx

    def dec(params, token, cache, cache_len):
        with shard_ctx.use(ctx):
            return model_lib.decode_step(params, cfg, token, cache,
                                         cache_len)

    dec = jax.jit(dec)
    toks = [np.asarray(rt.token)[:, 0].tolist()]
    token, cache, pos = rt.token, rt.cache, rt.cache_len
    for _ in range(GEN):
        lg, cache = dec(rt.state["params"], token, cache, pos)
        rows.append(np.asarray(lg))
        token = jnp.argmax(lg, -1)[:, None].astype(jnp.int32)
        pos = pos + 1
        toks.append(np.asarray(token)[:, 0].tolist())
    np.save(os.path.join(root, f"logits_{tag(name, mesh)}.npy"),
            np.stack(rows))
    return toks


if part == "train":
    for name, m in TRAIN:
        res[f"train_{tag(name, m)}"] = train(name, m)
else:
    for name in CFGS:
        job = serve_job(C, JobSpec, ShapeConfig, name)
        grant = BlockGrant.new([(0, 0, 0)], (1, 1), 600.0)
        rt = BlockRuntime(grant, job, jax.devices()[:1], root)
        rt.init_state()
        rt.save(async_=False)
    open(os.path.join(root, "done_serve_init"), "w").close()
    for name, m in SERVE:
        res[f"serve_{tag(name, m)}"] = serve(name, m)
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
                   world_size=world, timeout_s=250)
import repro_torch.configs as C
from repro_torch.core.block import BlockGrant
from repro_torch.core.runtime import BlockRuntime, JobSpec, OffRankRuntime
from repro_torch.data import pipeline
from repro_torch.device import Chip
from repro_torch.kernels import ops
from repro_torch.launch.hlo_analysis import tp_traffic
from repro_torch.models import model as model_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import flatten
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.train import optimizer as opt_lib
from torch.distributed.tensor import DTensor

ssm_lib.SLSTM_STACK_DTYPE = torch.float32
res = {}
SEEN = {"mlstm_heads": set(), "slstm_heads": set(), "up_cols": set(),
        "if_cols": set(), "gate_cols": set(), "conv": set(),
        "vocab": set(), "cut": set()}


def tapped(fn, note):
    def wrapper(*a, **kw):
        note(*a, **kw)
        return fn(*a, **kw)
    return wrapper


def noted(fn, note):
    def wrapper(*a, **kw):
        out = fn(*a, **kw)
        note(out)
        return out
    return wrapper


ops.mlstm_scan = tapped(ops.mlstm_scan, lambda q, *a, **kw: (
    SEEN["mlstm_heads"].add(q.shape[1])))
ops.mlstm_decode_step = tapped(ops.mlstm_decode_step, lambda q, *a: (
    SEEN["mlstm_heads"].add(q.shape[1])))
ssm_lib.causal_conv = tapped(ssm_lib.causal_conv, lambda x, w, tail=None: (
    SEEN["conv"].add(x.shape[-1])))
ssm_lib.mlstm_columns = noted(ssm_lib.mlstm_columns, lambda o: (
    SEEN["up_cols"].add(len(o[0])), SEEN["if_cols"].add(len(o[1]))))
ssm_lib.slstm_columns = noted(ssm_lib.slstm_columns, lambda o: (
    SEEN["gate_cols"].add(len(o))))
ssm_lib.slstm_fwd = noted(ssm_lib.slstm_fwd, lambda o: (
    SEEN["slstm_heads"].add(o[1]["slstm"][0].shape[1])))
# the leaves a forward cuts to the rank's columns itself (an exchanged
# leaf comes as them)
ssm_lib._take = tapped(ssm_lib._take, lambda w, cols: (
    w.shape[-1] != len(cols) and SEEN["cut"].add(w.shape[-1])))
model_lib._xent = tapped(
    model_lib._xent, lambda logits, *_: SEEN["vocab"].add(logits.shape[-1]))
# every decode step's logits, the whole batch's rows (the serve step
# calls the module's function, under the block's context)
LOGITS = []
_decode = model_lib.decode_step


def recording(*a, **k):
    out = _decode(*a, **k)
    LOGITS.append(shard_ctx.gather_rows(out[0]).detach().clone())
    return out


model_lib.decode_step = recording


def observe():
    for v in SEEN.values():
        v.clear()
    shard_ctx.GATHERED["model_bytes"] = 0
    shard_ctx.JOINED["model_bytes"] = 0


def observed():
    return {**{k: sorted(v) for k, v in SEEN.items()},
            "joined_bytes": shard_ctx.JOINED["model_bytes"]}


def brought(rt, **kw):
    """The bytes ``full`` brought this rank over ``model`` since
    ``observe`` beside the layout's count for its place in the model
    column: they differ from rank to rank, as the exchanged columns a
    rank lacks do."""
    return {"got": shard_ctx.GATHERED["model_bytes"],
            "want": rt.tp.step_bytes(rank=rt.mesh.get_coordinate()[-1],
                                     **kw)}


def traffic(cfg, shape, mesh):
    return tp_traffic(cfg, shape, {"data": mesh[0], "model": mesh[1]})["8d"]


def wait_for(path):
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > 250:
            raise TimeoutError(f"the reference wrote no {path}")
        time.sleep(0.2)


def whole(t):
    return t.detach().full_tensor() if isinstance(t, DTensor) else t.detach()


def digest(t):
    t = torch.as_tensor(whole(t)).contiguous()
    return hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy()
                          .tobytes()).hexdigest()


def train(name, mesh):
    shape, opt = train_setup(ShapeConfig, opt_lib.OptConfig)
    ns = f"train_{tag(name, mesh)}"
    wait_for(os.path.join(ref, f"done_{ns}"))
    n = mesh[0] * mesh[1]
    job = JobSpec(cfg_of(C, name), shape, kind="train", opt=opt, seed=0,
                  ckpt_namespace=ns)
    grant = BlockGrant.new([(0, i, 0) for i in range(n)], mesh, 600.0)
    rt = BlockRuntime(grant, job, devices=["cpu"] * n, ckpt_root=ref)
    rt.restore(step=0)
    observe()
    m = rt.step()
    free = [[m["loss"], m["grad_norm"]]]
    kw = dict(n_micro=shape.microbatch, remat=True, backward=True)
    res[f"brought_{ns}"] = brought(rt, **kw)
    out = {"tp": rt.tp.summary(), "seen": observed(),
           "want_bytes": rt.tp.step_bytes(**kw),
           "want_traffic": traffic(rt.job.cfg, shape, mesh)}
    for _ in range(2):
        m = rt.step()
        free.append([m["loss"], m["grad_norm"]])
    out["free"] = free
    arrs = {p: whole(t).float().numpy()
            for p, t in flatten(rt.state["params"])}
    if rank == 0:
        np.savez(os.path.join(root, f"{ns}.npz"), **arrs)
    rt.release()
    return out


def runtime(job, mesh, ranks):
    grant = BlockGrant.new([(0, r, 0) for r in ranks], mesh, 600.0)
    devices = [Chip(r, "cpu") for r in ranks]
    cls = BlockRuntime if rank in ranks else OffRankRuntime
    return cls(grant, job, devices, root)


def rebuild(old, mesh, ranks):
    grant = BlockGrant.new([(0, r, 0) for r in ranks], mesh, 600.0)
    devices = [Chip(r, "cpu") for r in ranks]
    cls = BlockRuntime if rank in ranks else OffRankRuntime
    return cls.rebuild(old, grant, devices, root)


def tokens(rt):
    return rt.token[:, 0].tolist()


def ctx_digests(rt):
    return {p: digest(t) for p, t in flatten(rt._decode_ctx())}


def cache_shapes(rt):
    return {p: list(t.shape) for p, t in flatten(rt.cache)}


def serve(name, mesh, ns=None, gen=GEN, keep=False):
    job = serve_job(C, JobSpec, ShapeConfig, name, ns)
    rt = runtime(job, mesh, list(range(mesh[0] * mesh[1])))
    rt.restore(step=0)
    box = {}
    from repro_torch.serve import serve_step
    pf = serve_step.make_prefill_step(rt.job.cfg)

    def fn(params, batch, cache):
        logits, cache = pf(params, batch, cache)
        box["logits"] = shard_ctx.gather_rows(logits)
        return logits, cache
    rt._prefill_fn = fn
    observe()
    rt.prefill(prompt(C, ShapeConfig, pipeline, name))
    key = f"brought_{ns or tag(name, mesh)}"
    res[key] = {"prefill": brought(rt)}
    out = {"prefill_seen": observed(), "want_bytes": rt.tp.step_bytes(1),
           "want_traffic": {
               "prefill": traffic(rt.job.cfg, ShapeConfig(
                   "p", "prefill", PROMPT, 4), mesh),
               "decode": traffic(rt.job.cfg, ShapeConfig(
                   "d", "decode", 1, 4), mesh)},
           "cache": cache_shapes(rt)}
    rows = [box["logits"]]
    toks = [tokens(rt)]
    LOGITS.clear()
    for i in range(gen):
        observe()
        rt.step()
        if i == 0:
            out["decode_seen"] = observed()
            res[key]["decode"] = brought(rt)
        toks.append(tokens(rt))
    rows += LOGITS
    if rank == 0:
        np.save(os.path.join(root, f"logits_{ns or tag(name, mesh)}.npy"),
                torch.stack(rows).numpy())
    out.update(tokens=toks, tp=rt.tp.summary())
    if not keep:
        rt.release()
    return out, rt


# ---- the runs
for name, m in TRAIN:
    if m[0] * m[1] == world:
        res[f"train_{tag(name, m)}"] = train(name, m)
wait_for(os.path.join(ref, "done_serve_init"))
if rank == 0:
    for name in CFGS:
        shutil.copytree(os.path.join(ref, f"serve_{name}"),
                        os.path.join(root, f"serve_{name}"))
    shutil.copytree(os.path.join(ref, "serve_a"),
                    os.path.join(root, "a_ckpt"))
dist.barrier()
for name, m in SERVE:
    if m[0] * m[1] == world:
        res[f"serve_{tag(name, m)}"], _ = serve(name, m)
if world == 2:
    # a context saved at (1, 2), each rank its heads' rows of the
    # states, resumed at (1, 1)
    out, rt = serve("a", (1, 2), ns="a_ckpt", gen=2, keep=True)
    seen = {"saved": ctx_digests(rt), "step": rt.step_count,
            "cache": cache_shapes(rt)}
    arrs = {p: whole(t).numpy() for p, t in flatten(rt._decode_ctx())}
    if rank == 0:
        np.savez(os.path.join(root, "a_ckpt_saved.npz"), **arrs)
    rt.suspend()
    rt = rebuild(rt, (1, 1), [1])
    if rank == 1:
        seen["resumed_11"] = {"ctx": ctx_digests(rt), "step": rt.step_count,
                              "cache": cache_shapes(rt)}
        rt.step()
        seen["resumed_11"]["next"] = tokens(rt)
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
    tmp = tmp_path_factory.mktemp("xlstm_parallel")
    ref = tmp / "ref"
    ref.mkdir()
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    deadline = time.time() + TIMEOUT_S
    refs = [subprocess.Popen(
        [sys.executable, "-c", REF, str(ref), part], cwd=str(tmp),
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in ("train", "serve")]
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
        a, b = _collect(refs, deadline)
    finally:
        for p in refs:
            p.kill()
    out["ref"] = {**a, **b}
    out["dir"] = tmp
    return out


def _first(lines, key):
    """``key`` as the first rank that has it has it, after checking that
    every rank holding it holds the same."""
    vals = [r[key] for r in lines if r.get(key) is not None]
    assert vals, key
    assert all(v == vals[0] for v in vals), (key, vals)
    return vals[0]


#: config: (d_model, n_heads), as ``COMMON``'s
CFGS = {"a": (64, 4), "b": (48, 4), "c": (64, 2)}


def _cfg(name, C=None):
    if C is None:
        import repro_torch.configs as C
    d, heads = CFGS[name]
    c = C.get_smoke("xlstm_350m")
    return dataclasses.replace(c, param_dtype="float32", d_model=d,
                               xlstm=dataclasses.replace(c.xlstm,
                                                         n_heads=heads))


def _layout(name, mesh):
    from repro_torch.sharding import plans
    return plans.tp_layout(_cfg(name), {"data": int(mesh[0]),
                                        "model": int(mesh[1])})


TRAIN_CASES = [("a12", 2), ("a22", 4), ("a14", 4), ("b12", 2), ("b14", 4),
               ("c14", 4)]
SERVE_CASES = [("a12", 2), ("a22", 4), ("a14", 4), ("b14", 4), ("c14", 4)]


def _kinds(name, M):
    """What the layout computes sharded for config ``name`` at M."""
    d, heads = CFGS[name]
    kinds = {"vocab"}
    if heads % M == 0:
        kinds |= {"mlstm", "slstm"}
    if int(d * 4 / 3) % M == 0:
        kinds.add("slstm_ff")
    return kinds


@pytest.mark.parametrize("case,world", TRAIN_CASES,
                         ids=[m for m, _ in TRAIN_CASES])
def test_train_steps_match_the_reference_on_the_same_mesh(runs, case,
                                                          world):
    """Losses and grad norms at rtol 1e-4, the params after 3 steps at
    atol 2e-3."""
    got = _first(runs[world], f"train_{case}")
    want = np.asarray(runs["ref"][f"train_{case}"])
    np.testing.assert_allclose(got["free"], want, rtol=1e-4)
    import jax
    import repro.configs as JC
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.train import optimizer as jopt
    from repro.train import train_step as jtrain
    cfg = _cfg(case[0], JC)
    opt = jopt.OptConfig(lr=3e-3, warmup_steps=2, total_steps=20, eps=1e-3)
    like = {"state": jtrain.abstract_train_state(cfg, opt), "step_count": 0}
    ref, at = JManager(str(runs["dir"] / "ref"), f"train_{case}").restore(
        like, step=3)
    assert at == 3
    mine = np.load(runs["dir"] / f"port{world}" / f"train_{case}.npz")
    flat = jax.tree_util.tree_flatten_with_path(ref["state"]["params"])[0]
    assert len(flat) == len(mine.files) == 18
    for path, leaf in flat:
        name = "/".join(k.key for k in path)
        np.testing.assert_allclose(mine[name], np.asarray(leaf), atol=2e-3,
                                   err_msg=name)


def _held_shares(seen, name, M):
    """The heads, columns and vocabulary a rank's calls saw."""
    d, H = CFGS[name]
    cfg = _cfg(name)
    inner = 2 * d
    sharded = H % M == 0
    Hl = H // M if sharded else H
    assert seen["mlstm_heads"] == [Hl]
    assert seen["slstm_heads"] == [Hl]
    assert seen["conv"] == [inner]
    if sharded and M > 1:
        assert seen["up_cols"] == [inner + inner // M]
        assert seen["if_cols"] == [2 * H // M]
        assert seen["gate_cols"] == [4 * d // M]
        # only ``w_if``, which the plan replicates, is cut by the
        # forward: ``w_up`` and ``w_gates`` come exchanged
        assert seen["cut"] == [2 * H]
    else:
        assert seen["up_cols"] == seen["if_cols"] == seen["gate_cols"] == []
        assert seen["cut"] == []
    return cfg


def _brought(lines, key):
    """Each rank's ``brought`` line (its own bytes over ``model`` and
    the layout's count for its place in the model column), checked
    equal, and the most any rank received."""
    got = [r[key] for r in lines if key in r]
    assert got, key
    for b in got:
        assert b["got"] == b["want"], (key, got)
    return max(b["got"] for b in got)


def _flat_meta(cfg):
    from repro_torch.models import model
    from repro_torch.models.transformer import flatten
    return flatten(model.abstract_params(cfg))


def _exchange_count(cfg, M):
    """For each rank of a model column of M, the bytes of ``w_up`` and
    ``w_gates`` that a forward's exchange brings it and that a
    backward's brings back to it, counted from ``ssm.mlstm_columns``,
    ``ssm.slstm_columns`` and the plan's contiguous chunks: the columns
    it needs that another rank's chunk holds, and the columns of its
    chunk that another rank needs."""
    from repro_torch.models import ssm
    leaves = dict(_flat_meta(cfg))
    fwd, back = [0] * M, [0] * M
    for path, cols in (
            ("layers/mlstm/blk/w_up", lambda r: ssm.mlstm_columns(
                cfg.d_model, cfg.xlstm, M, r)[0]),
            ("layers/slstm/blk/w_gates", lambda r: ssm.slstm_columns(
                cfg.d_model, cfg.xlstm, M, r))):
        leaf = leaves[path]
        C = leaf.shape[-1]
        col = leaf.numel() * leaf.element_size() // C
        for r in range(M):
            for c in cols(r):
                if c // (C // M) != r:
                    fwd[r] += col
                    back[c // (C // M)] += col
    return fwd, back


@pytest.mark.parametrize("case,world", TRAIN_CASES,
                         ids=[m for m, _ in TRAIN_CASES])
def test_each_rank_computes_its_share_of_the_xlstm(runs, case, world):
    """The mLSTM's scan and the sLSTM's recurrence see H / M heads (H
    where the layout keeps them whole), a rank has its columns of
    ``w_up``, ``w_if`` and ``w_gates``, the loss sees V / M of the
    vocabulary; ``full`` brings each rank over ``model`` exactly the
    bytes of the leaves gathered whole and the columns of ``w_up`` and
    ``w_gates`` it lacks, their gradients back (``_exchange_count``),
    less than gathering those whole, and the joins what ``tp_traffic``
    computes beside them."""
    got = _first(runs[world], f"train_{case}")
    name, M = case[0], int(case[2])
    lay = _layout(name, case[1:])
    assert got["tp"] == lay.summary()
    assert lay.kinds == _kinds(name, M)
    seen = got["seen"]
    cfg = _held_shares(seen, name, M)
    assert seen["vocab"] == [cfg.vocab_size // M]
    most = _brought(runs[world], f"brought_train_{case}")
    assert most == got["want_bytes"] == lay.step_bytes(
        2, remat=True, backward=True) > 0
    if lay.computes("mlstm") and M > 1:
        fwd, back = _exchange_count(cfg, M)
        assert list(lay.exchange_in) == fwd
        assert list(lay.exchange_back) == back
        assert most < lay.step_bytes_whole(2, remat=True, backward=True)
    else:
        assert not lay.exchange
    assert seen["joined_bytes"] > 0
    assert most + seen["joined_bytes"] == got["want_traffic"]


def _logits_held(runs, world, case):
    mine = np.load(runs["dir"] / f"port{world}" / f"logits_{case}.npy")
    want = np.load(runs["dir"] / "ref" / f"logits_{case}.npy")
    assert mine.shape == want.shape == (1 + 3, 4, 256)
    for m, w in zip(mine, want):
        np.testing.assert_allclose(m, w, rtol=0, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("case,world", SERVE_CASES,
                         ids=[m for m, _ in SERVE_CASES])
def test_dense_plane_matches_the_reference_on_the_same_mesh(runs, case,
                                                            world):
    """Greedy tokens equal, the prefill's and every decode step's
    logits within 1e-4 of their largest magnitude; each rank's decode
    states of its heads and the whole conv tail; the bytes over
    ``model`` a prefill and a decode step as ``TPLayout`` and
    ``tp_traffic`` compute them."""
    got = _first(runs[world], f"serve_{case}")
    assert got["tokens"] == runs["ref"][f"serve_{case}"]
    _logits_held(runs, world, case)
    name, dp, M = case[0], int(case[1]), int(case[2])
    lay = _layout(name, case[1:])
    assert got["tp"] == lay.summary()
    d, H = CFGS[name]
    Hl = H // M if H % M == 0 else H
    for phase in ("prefill", "decode"):
        seen = got[f"{phase}_seen"]
        _held_shares(seen, name, M)
        most = _brought([r[f"brought_{case}"] for r in runs[world]], phase)
        assert most == got["want_bytes"] == lay.step_bytes(1)
        assert most + seen["joined_bytes"] == got["want_traffic"][phase]
    rows = 4 // dp
    cache = got["cache"]
    assert cache["mlstm/conv"] == [2, 1, rows, 3, 2 * d]
    assert cache["mlstm/mlstm/0"] == [2, 1, rows, Hl, d // H, 2 * d // H]
    assert cache["mlstm/mlstm/2"] == [2, 1, rows, Hl]
    for i in range(4):
        assert cache[f"slstm/slstm/{i}"] == [2, rows, Hl, d // H]


def test_a_context_saved_at_12_resumes_at_11(runs):
    lines = runs[2]
    ck = [r["ckpt"] for r in lines]
    saved = _first(ck, "saved")
    assert _first(ck, "step") == 2
    assert _first(ck, "cache")["slstm/slstm/0"][-2] == 2
    want_next = runs["ref"]["serve_a12"][3]
    assert want_next == _first(lines, "serve_a12")["tokens"][3]
    r11 = lines[1]["ckpt"]["resumed_11"]
    assert r11["ctx"] == saved and r11["step"] == 2
    assert r11["cache"]["slstm/slstm/0"][-2] == 4
    assert r11["cache"]["mlstm/mlstm/0"][-3] == 4
    assert r11["next"] == want_next
    assert "resumed_11" not in lines[0]["ckpt"]


def test_a_context_saved_at_12_is_the_references_format(runs):
    """The (1, 2) save holds whole leaves: the JAX package restores it,
    every cache leaf (both ranks' heads of the states, the conv tail)
    bit for bit the saved ones."""
    import jax
    import jax.numpy as jnp
    import repro.configs as JC
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.models import model as jmodel
    from repro.serve import serve_step as jserve
    cfg = _cfg("a", JC)
    like = {"state": {"params": jmodel.abstract_params(cfg)},
            "step_count": 0,
            "decode": {"cache": jserve.abstract_cache(cfg, 4, 20),
                       "token": jax.ShapeDtypeStruct((4, 1), np.int32),
                       "cache_len": jax.ShapeDtypeStruct((), np.int32)}}
    tree, at = JManager(str(runs["dir"] / "port2"), "a_ckpt").restore(
        like, step=2)
    assert at == 2 and int(tree["decode"]["cache_len"]) == 16 + 2
    saved = np.load(runs["dir"] / "port2" / "a_ckpt_saved.npz")
    flat = jax.tree_util.tree_flatten_with_path(tree["decode"]["cache"])[0]
    assert len(flat) == 8
    for path, leaf in flat:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        mine = saved[f"cache/{name}"]
        assert mine.shape == leaf.shape, name
        if name.endswith("conv"):
            # the reference's restore target rounds an fp32 model's conv
            # tail to bf16 (ROADMAP queue 3's noted behaviours)
            mine = np.asarray(jnp.asarray(mine).astype(leaf.dtype))
        np.testing.assert_array_equal(np.asarray(leaf), mine, err_msg=name)


# ------------------------------------------------------------- in process

def test_the_layout_rule_on_xlstm_350m():
    """xlstm_350m (4 heads, feed-forward 1365, vocabulary 50304): at
    M = 1 everything sharded and nothing kept; at M = 2 and 4 the heads
    and vocabulary sharded, the odd feed-forward kept by its named rule;
    at M = 8 and 16 the heads kept too, the vocabulary still split;
    never the old ``family: xlstm``."""
    import repro_torch.configs as C
    from repro_torch.sharding import plans
    cfg = C.get("xlstm_350m")
    mlstm = {f"layers/mlstm/blk/{n}" for n in plans.MLSTM_SLICED}
    slstm = {f"layers/slstm/blk/{n}" for n in plans.SLSTM_SLICED}
    for M in (1, 2, 4, 8, 16):
        lay = plans.tp_layout(cfg, {"data": 1, "model": M})
        assert not any(k.startswith("family") for k in lay.kept)
        assert "vocab" in lay.kinds and "embed" in lay.leaves
        if M == 1:
            assert lay.kinds == {"mlstm", "slstm", "slstm_ff", "vocab"}
            assert lay.kept == ()
        elif M in (2, 4):
            assert lay.kinds == {"mlstm", "slstm", "vocab"}
            assert lay.kept == (f"slstm_ff: 1365 % {M}",)
        else:
            assert lay.kinds == {"vocab"}
            assert lay.kept == (f"slstm_ff: 1365 % {M}",
                                f"xlstm: heads 4 % {M}")
        if M <= 4:
            assert lay.heads == (4 // M, 4 // M)
            assert lay.partial == mlstm | slstm
            assert {f"layers/mlstm/blk/{n}" for n in
                    ("wq", "wk", "wv", "w_down")} <= lay.leaves
        else:
            assert lay.heads == (4, 4) and not lay.partial
    # a group a rank holds at M = 2 against 8a's whole group
    two = plans.tp_layout(cfg, {"data": 1, "model": 2})
    assert two.group_bytes < two.group_bytes_whole
    assert plans.tp_layout(cfg, {"data": 1, "model": 2}, paged=True).kept \
        == ("paged",)


@pytest.mark.parametrize("world", [2, 4])
def test_the_exchange_is_the_whole_gathers_columns(tmp_path, world):
    """On 2 and 4 gloo ranks, config "a"'s ``w_up`` and ``w_gates``
    through the exchange against gathered whole and cut
    (``tests/test_torch_hybrid_parallel.py``'s ``EXCHANGE``): forward
    bit for bit, the gradient on each rank's chunk bit for bit for
    ``z`` and the gates, within fp32 roundoff for ``xm``, which every
    rank reads."""
    from test_torch_hybrid_parallel import exchange_world, held_exchange
    d, H = CFGS["a"]
    lines = exchange_world(tmp_path, world, "xlstm_350m",
                           {"d_model": d, "n_heads": H})
    lay = held_exchange(lines, _cfg("a"), world)
    assert set(lay.exchange) == {"layers/mlstm/blk/w_up",
                                 "layers/slstm/blk/w_gates"}
    assert sum(line["layers/mlstm/blk/w_up"]["n_shared"]
               for line in lines) == 2 * d          # all of xm
    assert all(line["layers/slstm/blk/w_gates"]["n_shared"] == 0
               for line in lines)


@pytest.mark.parametrize("M", [2, 4])
def test_xlstm_350m_full_width_exchange_bytes(M):
    """xlstm_350m at full width on a (1, M) mesh, abstract params: the
    bytes the layout counts over ``model``, forward and back, are a
    direct count from the column lists and the plan's chunks, below the
    whole gather's; at (1, 4) a rank needs 1024 of ``w_gates``' 4096
    columns, and brings the 768 its chunk lacks where the whole gather
    brings 3072."""
    import repro_torch.configs as C
    from repro_torch.sharding import plans
    cfg = C.get("xlstm_350m")
    lay = plans.tp_layout(cfg, {"data": 1, "model": M})
    fwd, back = _exchange_count(cfg, M)
    assert list(lay.exchange_in) == fwd and list(lay.exchange_back) == back
    assert lay.step_bytes(1) < lay.step_bytes_whole(1)
    assert lay.step_bytes(2, remat=True, backward=True) < \
        lay.step_bytes_whole(2, remat=True, backward=True)
    gates = lay.exchange["layers/slstm/blk/w_gates"]
    chunk = 4 * cfg.d_model // M
    for r, cols in enumerate(gates):
        assert len(cols) == 4 * cfg.d_model // M
        if M == 4:
            assert len(cols) == 1024
            assert sum(1 for c in cols if c // chunk != r) == 768


@pytest.mark.parametrize("name", ["a", "b"])
def test_a_ranks_columns_cover_the_leaves_once(name):
    """Over the ranks of a column the ``z`` columns of ``w_up``, the
    ``i`` and ``f`` of ``w_if`` and every gate's columns of ``w_gates``
    cover the leaf once, each rank its heads', and every rank takes all
    of ``xm``."""
    from repro_torch.models import ssm
    cfg = _cfg(name)
    d, H = CFGS[name]
    inner = 2 * d
    for M in (1, 2, 4):
        ups, ifs, gates = [], [], []
        for r in range(M):
            up, wif = ssm.mlstm_columns(d, cfg.xlstm, M, r)
            assert up[:inner] == list(range(inner))
            assert len(up) == inner + inner // M and len(wif) == 2 * H // M
            assert wif[:H // M] == list(range(r * H // M, (r + 1) * H // M))
            ups += up[inner:]
            ifs += wif
            g = ssm.slstm_columns(d, cfg.xlstm, M, r)
            assert len(g) == 4 * d // M
            assert g[:d // M] == list(range(r * d // M, (r + 1) * d // M))
            gates += g
        assert sorted(ups) == list(range(inner, 2 * inner))
        assert sorted(ifs) == list(range(2 * H))
        assert sorted(gates) == list(range(4 * d))


def test_cache_layouts_put_the_xlstm_heads_on_model():
    """``cache_layouts`` with a layout computing the heads: the states'
    head dim (after the batch) over ``model``, the conv tail whole; with
    the heads kept, every state whole over ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models import model
    from repro_torch.models.transformer import flatten
    from repro_torch.sharding import plans
    cfg = _cfg("a")
    mesh = {"data": 1, "model": 2}
    lay = plans.tp_layout(cfg, mesh)
    abstract = model.init_cache(cfg, 4, 8, "meta")
    got = dict(flatten(plans.cache_layouts(abstract, mesh, split=True,
                                           tp=lay)))
    assert got["mlstm/conv"].placements == (Shard(2), Replicate())
    for i in range(3):
        assert got[f"mlstm/mlstm/{i}"].placements == (Shard(2), Shard(3))
    for i in range(4):
        assert got[f"slstm/slstm/{i}"].placements == (Shard(1), Shard(2))
    kept = plans.tp_layout(_cfg("c"), {"data": 1, "model": 4})
    got = dict(flatten(plans.cache_layouts(
        model.init_cache(_cfg("c"), 4, 8, "meta"), {"data": 1, "model": 4},
        split=True, tp=kept)))
    assert all(lay.placements[1] == Replicate() for lay in got.values())
    # a rank's cache: its heads' states, the conv tail whole
    split = dict(flatten(model.init_cache(cfg, 4, 8, "meta",
                                          xlstm_split=2)))
    assert list(split["mlstm/mlstm/0"].shape) == [2, 1, 4, 2, 16, 32]
    assert list(split["slstm/slstm/3"].shape) == [2, 4, 2, 16]
    assert list(split["mlstm/conv"].shape) == [2, 1, 4, 3, 128]


XLSTM_DRYRUN = r'''
import json
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
from torch._subclasses.fake_tensor import FakeTensorMode
import repro_torch.configs as C

out = {}
dryrun.fake_world(256)
mesh = dryrun.block_mesh(None, False)
for shape in ("prefill_32k", "decode_32k"):
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell, meta = dryrun.lower_cell("xlstm_350m", shape,
                                       multi_pod=False, mesh=mesh)
    out[shape] = {"gaps": cell.gaps, "cache": meta.get("cache")}
# the smoke config's decode at (1, 2), its heads sharded
dryrun.fake_world(2)
small = dryrun.block_mesh((1, 2), False)
dec = ShapeConfig("d", "decode", seq_len=32, global_batch=4)
with FakeTensorMode(allow_non_fake_inputs=True):
    cell, meta = dryrun.lower_cell("xlstm_350m", "d", multi_pod=False,
                                   cfg=C.get_smoke("xlstm_350m"),
                                   shape=dec, mesh=small)
out["smoke_12"] = {"gaps": cell.gaps, "cache": meta["cache"]}
print("RESULT " + json.dumps(out))
'''


def test_dryrun_xlstm_cells_name_what_is_still_kept():
    """The dry run's xlstm cells on the 16x16 mesh name the heads and
    the feed-forward kept whole (4 and 1365 do not divide by 16), not
    ``family: xlstm``; the conv tail departs from the reference spec for
    its own reason.  At (1, 2) the smoke config's states hold a rank's
    heads: half the bytes of the reference spec's, each departure
    named."""
    r = subprocess.run([sys.executable, "-c", XLSTM_DRYRUN], env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    out = json.loads(line[-1][len("RESULT "):])
    for shape in ("prefill_32k", "decode_32k"):
        gaps = out[shape]["gaps"]
        assert len(gaps) == 2 and not any("family" in g for g in gaps)
        assert "slstm_ff: 1365 % 16" in gaps[0]
        assert "xlstm: heads 4 % 16" in gaps[1]
        departs = out[shape]["cache"]["departs"]
        assert set(departs) == {"conv"} and "mLSTM" in departs["conv"]
    small = out["smoke_12"]
    assert small["gaps"] == ["8g: slstm_ff: 85 % 2 kept in 8a's layout "
                             "(every rank of a model column computes it "
                             "whole)"]
    cache = small["cache"]
    assert set(cache["departs"]) == {"conv", "mlstm", "slstm"}
    for n in ("mlstm", "slstm"):
        assert 2 * cache["bytes"][n] == cache["reference_bytes"][n]
        assert "heads" in cache["departs"][n]
    assert cache["bytes"]["conv"] == 2 * cache["reference_bytes"]["conv"]


# ------------------------------------------------------------ chip_smoke

def test_chip_smoke_xlstm_sharded_phase_on_cpu():
    """``chip_smoke.py``'s xlstm_sharded at smoke size on the CPU (gloo,
    one rank): the sharded train block's losses, grad norms and
    launches train_xlstm's, the sharded serve block's tokens, logits and
    launches serve_xlstm's, bit for bit, on the tensor-parallel path;
    the process group destroyed after."""
    root = os.path.join(os.path.dirname(__file__), "..")
    code = f"""
import sys
sys.path.insert(0, {os.path.abspath(root)!r})
import torch
torch.set_num_threads(1)
import chip_smoke as c
train = c.phase_train_xlstm(device="cpu", smoke=True)
serve = c.phase_serve_xlstm(device="cpu", smoke=True)
out = c.phase_xlstm_sharded(device="cpu", smoke=True, train=train,
                            serve=serve)
t, s = out["train"], out["serve"]
assert t["losses_equal_train_xlstm"] and t["grad_norms_equal_train_xlstm"]
assert t["launches_per_step_equal_train_xlstm"]
assert t["tp"]["sharded"] == ["mlstm", "slstm", "slstm_ff", "vocab"]
assert s["tokens_equal_serve_xlstm"] and s["logits_equal_serve_xlstm"]
assert s["launches_equal_serve_xlstm"]
assert s["launches_per_replay_equal_serve_xlstm"]
import torch.distributed as dist
assert not dist.is_initialized()
print("XLSTM_SHARDED_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=ENV, cwd=root)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "XLSTM_SHARDED_OK" in r.stdout
