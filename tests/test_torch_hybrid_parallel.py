"""The hybrid family over ``model`` and a B = 1 cache's sequence over
``data`` (item 8g, parts 1 and 3) on gloo ranks on the CPU, against the
JAX package's runs on the same mesh shapes.

The reference runs in two subprocesses with 4 forced host devices each,
at once (``REF``, parts "train" and "serve"): the train part runs
zamba2_2p7b's smoke config in fp32 (8 Mamba2 heads, 4/4 attention
heads) at (1, 2), (2, 2) and (1, 4), 3 steps each from its own init,
saving every step; the serve part saves two serve blocks' inits, then
prefills a 4 x 16 prompt and decodes 3 greedy steps on the dense plane
at (1, 2), and a 1 x 10 prompt into a cache of 24 positions, decoding 3
steps (positions 10, 11, 12), at (2, 1), (4, 1) and (2, 2).  At dp = 2
the slices are 12 positions and at dp = 4 six: the prompt spans two
ranks' slices at dp = 4, and the decode crosses from one slice into the
next at both.  The port's worlds of 4 and 2 gloo ranks (``RANKS``, one
spawn per world size, as ``tests/test_torch_tensor_parallel.py``)
restore those checkpoints as they land, run the same steps and traffic
on the same meshes and print one JSON line each.

Held, with ``tests/test_torch_tensor_parallel.py``'s tolerances:
* train: losses and grad norms at rtol 1e-4 over 3 free-running steps
  at lr 3e-3 (the hybrid's trajectory is chaotic at 1e-2, ROADMAP queue
  3), the params after 3 steps at atol 2e-3;
* serve: greedy tokens equal, prefill and every decode step's logits
  within 1e-4 of their largest magnitude;
* what each rank computes: the SSD scan and its decode step see H / M
  Mamba2 heads, the attention Hq / M and Hkv / M heads, the loss V / M
  of the vocabulary; the ``ssm`` state holds H / M heads, the ``conv``
  state the rank's heads' channels and B and C, the K/V cache Hkv / M
  heads and, at dp > 1 with B = 1, Smax / dp positions; the bytes
  ``full`` brings over ``model`` and the joins' bytes as
  ``plans.TPLayout`` and ``hlo_analysis.tp_traffic`` compute them;
* a context saved at (2, 1) (each rank a slice of the positions)
  resumes at (1, 1) and (1, 2): its whole leaves bit for bit, the next
  token the uninterrupted run's; the JAX package restores the saved
  files, every leaf bit for bit (the fp32 conv tail as the reference's
  bf16 restore target rounds it);
* in process: the chunked and merged ``decode_attention`` against the
  whole-softmax one, with and without a sliding window, and merged
  across slices as the data ranks merge.
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

ZB = "zamba2_2p7b"
TRAIN = ((1, 2), (2, 2), (1, 4))
PROMPT, GEN = 16, 3
LONG_P, LONG_SMAX = 10, 24
LONG = ((2, 1), (4, 1), (2, 2))


def fp32(C):
    return dataclasses.replace(C.get_smoke(ZB), param_dtype="float32")


def train_setup(Shape, Opt):
    return (Shape("t", "train", seq_len=32, global_batch=4, microbatch=2),
            Opt(lr=3e-3, warmup_steps=1, total_steps=4))


def dense_job(C, Job, Shape):
    return Job(fp32(C), Shape("s", "serve", seq_len=PROMPT + GEN + 1,
                              global_batch=4),
               kind="serve", ckpt_namespace="serve_dense")


def long_job(C, Job, Shape, ns="serve_long"):
    return Job(fp32(C), Shape("s", "serve", seq_len=LONG_SMAX,
                              global_batch=1),
               kind="serve", ckpt_namespace=ns)


def prompt(C, Shape, pipeline, B, P):
    return {k: v for k, v in pipeline.synthetic_batch(
        fp32(C), Shape("p", "prefill", seq_len=P, global_batch=B),
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
from repro.models.config import ShapeConfig
from repro.sharding import ctx as shard_ctx, plans
from repro.train import optimizer as opt_lib, train_step as train_lib

root, part = sys.argv[1], sys.argv[2]
res = {}


def mesh_of(shape):
    devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return jax.sharding.Mesh(devs, ("data", "model"))


def train(mesh_shape, n=3):
    cfg = fp32(C)
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
    ns = f"train_{mesh_shape[0]}{mesh_shape[1]}"
    mgr = CheckpointManager(root, ns, keep=10)
    mgr.save(0, {"state": state, "step_count": 0})
    hist = []
    for i in range(n):
        state, m = jstep(state, data.batch(i))
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        mgr.save(i + 1, {"state": state, "step_count": i + 1})
    open(os.path.join(root, f"done_{ns}"), "w").close()
    return hist


def serve(job, mesh, B, P, tag):
    """The reference's serve block on ``mesh`` from its saved init: the
    prefill's logits and tokens, then ``GEN`` decode steps, each the
    block's own decode (``model.decode_step`` and the argmax, jitted
    under the block's context) with its logits kept."""
    n = mesh[0] * mesh[1]
    grant = BlockGrant.new([(0, i, 0) for i in range(n)], mesh, 600.0)
    rt = BlockRuntime(grant, job, jax.devices()[:n], root)
    rt.restore(step=0)
    batch = prompt(C, ShapeConfig, pipeline, B, P)
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
    np.save(os.path.join(root, f"logits_{tag}.npy"), np.stack(rows))
    return toks


if part == "train":
    for m in TRAIN:
        res[f"train_{m[0]}{m[1]}"] = train(m)
else:
    for job in (dense_job(C, JobSpec, ShapeConfig),
                long_job(C, JobSpec, ShapeConfig)):
        grant = BlockGrant.new([(0, 0, 0)], (1, 1), 600.0)
        rt = BlockRuntime(grant, job, jax.devices()[:1], root)
        rt.init_state()
        rt.save(async_=False)
    open(os.path.join(root, "done_serve_init"), "w").close()
    res["dense_12"] = serve(dense_job(C, JobSpec, ShapeConfig), (1, 2), 4,
                            PROMPT, "dense_12")
    for m in LONG:
        tag = f"long_{m[0]}{m[1]}"
        res[tag] = serve(long_job(C, JobSpec, ShapeConfig), m, 1, LONG_P,
                         tag)
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
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import flatten
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.train import optimizer as opt_lib
from torch.distributed.tensor import DTensor

res = {}
SEEN = {"heads": set(), "mamba_heads": set(), "vocab": set(),
        "conv": set(), "ssm": set(), "cut": set()}


def tapped(fn, note):
    def wrapper(*a, **kw):
        note(*a, **kw)
        return fn(*a, **kw)
    return wrapper


def attn_seen(q, k, *_, **__):
    SEEN["heads"].add((q.shape[1], k.shape[1]))


ops.flash_attention = tapped(ops.flash_attention, attn_seen)
ops.decode_attention = tapped(ops.decode_attention, attn_seen)
ops.ssd_scan = tapped(ops.ssd_scan, lambda x, *a, **kw: (
    SEEN["mamba_heads"].add(x.shape[2]),
    kw.get("h0") is not None and SEEN["ssm"].add(tuple(kw["h0"].shape))))
ops.ssd_decode_step = tapped(ops.ssd_decode_step, lambda x, *a: (
    SEEN["mamba_heads"].add(x.shape[1]), SEEN["ssm"].add(tuple(a[-1].shape))))
from repro_torch.models import ssm as ssm_lib
ssm_lib.causal_conv = tapped(ssm_lib.causal_conv, lambda x, w, tail=None: (
    SEEN["conv"].add(x.shape[-1])))
# the leaves a forward cuts to the rank's columns itself (an exchanged
# leaf comes as them)
ssm_lib._take = tapped(ssm_lib._take, lambda w, cols: (
    w.shape[-1] != len(cols) and SEEN["cut"].add(w.shape[-1])))
model_lib._xent = tapped(
    model_lib._xent, lambda logits, *_: SEEN["vocab"].add(logits.shape[-1]))
# every decode step's logits (the serve step calls the module's function)
LOGITS = []
_decode = model_lib.decode_step


def recording(*a, **k):
    out = _decode(*a, **k)
    LOGITS.append(out[0].detach().clone())
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


def train(mesh):
    shape, opt = train_setup(ShapeConfig, opt_lib.OptConfig)
    ns = f"train_{mesh[0]}{mesh[1]}"
    wait_for(os.path.join(ref, f"done_{ns}"))
    n = mesh[0] * mesh[1]
    job = JobSpec(fp32(C), shape, kind="train", opt=opt, seed=0,
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
    return {p.split("/")[-1]: list(t.shape) for p, t in flatten(rt.cache)}


def serve(job, mesh, B, P, tag, gen=GEN, keep=False):
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
    rt.prefill(prompt(C, ShapeConfig, pipeline, B, P))
    res[f"brought_{tag}"] = {"prefill": brought(rt)}
    out = {"prefill_seen": observed(), "want_bytes": rt.tp.step_bytes(1),
           "want_traffic": {
               "prefill": traffic(rt.job.cfg, ShapeConfig(
                   "p", "prefill", P, B), mesh),
               "decode": traffic(rt.job.cfg, ShapeConfig(
                   "d", "decode", 1, B), mesh)},
           "seq_split": rt.ctx.seq_split, "cache": cache_shapes(rt)}
    rows = [box["logits"]]
    toks = [tokens(rt)]
    LOGITS.clear()
    for i in range(gen):
        observe()
        rt.step()
        if i == 0:
            out["decode_seen"] = observed()
            res[f"brought_{tag}"]["decode"] = brought(rt)
        toks.append(tokens(rt))
    rows += LOGITS          # the whole batch: its rows do not split here
    if rank == 0:
        np.save(os.path.join(root, f"logits_{tag}.npy"),
                torch.stack(rows).numpy())
    out.update(tokens=toks, tp=rt.tp.summary())
    if not keep:
        rt.release()
    return out, rt


# ---- the runs
for m in TRAIN:
    if m[0] * m[1] == world:
        res[f"train_{m[0]}{m[1]}"] = train(m)
wait_for(os.path.join(ref, "done_serve_init"))
if rank == 0:
    for ns in ("serve_dense", "serve_long"):
        shutil.copytree(os.path.join(ref, ns), os.path.join(root, ns))
    shutil.copytree(os.path.join(ref, "serve_long"),
                    os.path.join(root, "long_ckpt"))
dist.barrier()
if world == 2:
    res["dense_12"], _ = serve(dense_job(C, JobSpec, ShapeConfig), (1, 2),
                               4, PROMPT, "dense_12")
for m in LONG:
    if m[0] * m[1] == world:
        tag = f"long_{m[0]}{m[1]}"
        res[tag], _ = serve(long_job(C, JobSpec, ShapeConfig), m, 1,
                            LONG_P, tag)
if world == 2:
    # a B = 1 context saved at (2, 1), each rank a slice of the
    # positions, resumed at (1, 1) and at (1, 2)
    out, rt = serve(long_job(C, JobSpec, ShapeConfig, "long_ckpt"), (2, 1),
                    1, LONG_P, "long_ckpt", gen=2, keep=True)
    seen = {"saved": ctx_digests(rt), "step": rt.step_count,
            "cache": cache_shapes(rt)}
    arrs = {p: whole(t).numpy() for p, t in flatten(rt._decode_ctx())}
    if rank == 0:
        np.savez(os.path.join(root, "long_ckpt_saved.npz"), **arrs)
    rt.suspend()
    for name, mesh, ranks in (("resumed_11", (1, 1), [1]),
                              ("resumed_12", (1, 2), [0, 1])):
        rt = rebuild(rt, mesh, ranks)
        if rank in ranks:
            seen[name] = {"ctx": ctx_digests(rt), "step": rt.step_count,
                          "cache": cache_shapes(rt)}
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
    tmp = tmp_path_factory.mktemp("hybrid_parallel")
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


def _fp32():
    import repro_torch.configs as C
    return dataclasses.replace(C.get_smoke("zamba2_2p7b"),
                               param_dtype="float32")


def _layout(mesh):
    from repro_torch.sharding import plans
    return plans.tp_layout(_fp32(), {"data": int(mesh[0]),
                                     "model": int(mesh[1])})


TRAIN_CASES = [("12", 2), ("22", 4), ("14", 4)]


@pytest.mark.parametrize("mesh,world", TRAIN_CASES,
                         ids=[m for m, _ in TRAIN_CASES])
def test_train_steps_match_the_reference_on_the_same_mesh(runs, mesh,
                                                          world):
    """Losses and grad norms at rtol 1e-4, the params after 3 steps at
    atol 2e-3."""
    got = _first(runs[world], f"train_{mesh}")
    want = np.asarray(runs["ref"][f"train_{mesh}"])
    np.testing.assert_allclose(got["free"], want, rtol=1e-4)
    import jax
    import repro.configs as JC
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.train import optimizer as jopt
    from repro.train import train_step as jtrain
    cfg = dataclasses.replace(JC.get_smoke("zamba2_2p7b"),
                              param_dtype="float32")
    opt = jopt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=4)
    like = {"state": jtrain.abstract_train_state(cfg, opt), "step_count": 0}
    ref, at = JManager(str(runs["dir"] / "ref"), f"train_{mesh}").restore(
        like, step=3)
    assert at == 3
    mine = np.load(runs["dir"] / f"port{world}" / f"train_{mesh}.npz")
    flat = jax.tree_util.tree_flatten_with_path(ref["state"]["params"])[0]
    assert len(flat) == len(mine.files)
    for path, leaf in flat:
        name = "/".join(k.key for k in path)
        np.testing.assert_allclose(mine[name], np.asarray(leaf), atol=2e-3,
                                   err_msg=name)


def _brought(lines, key):
    """Each rank's ``brought`` line (its own bytes over ``model`` and
    the layout's count for its place in the model column), checked
    equal, and the most any rank received."""
    got = [r[key] for r in lines if key in r]
    assert got, key
    for b in got:
        assert b["got"] == b["want"], (key, got)
    return max(b["got"] for b in got)


@pytest.mark.parametrize("mesh,world", TRAIN_CASES,
                         ids=[m for m, _ in TRAIN_CASES])
def test_each_rank_computes_its_share_of_the_hybrid(runs, mesh, world):
    """The SSD scan sees H / M Mamba2 heads, flash Hq / M and Hkv / M
    attention heads, the loss V / M of the vocabulary, the conv the
    rank's heads' channels and B and C; no forward cuts a leaf to its
    columns itself (``w_in`` and ``conv_w`` come exchanged); ``full``
    brings each rank over ``model`` exactly the columns of ``w_in`` and
    ``conv_w`` it lacks, their gradients back and the gathered ``norm``
    (``_exchange_count``), less than gathering them whole, and the joins
    what ``tp_traffic`` computes beside them."""
    got = _first(runs[world], f"train_{mesh}")
    lay = _layout(mesh)
    cfg = _fp32()
    M = int(mesh[1])
    H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    assert got["tp"] == lay.summary() and lay.kept == ()
    assert lay.kinds == {"attn", "mamba", "mlp", "vocab"}
    seen = got["seen"]
    assert seen["heads"] == [[cfg.attention.n_heads // M,
                              cfg.attention.n_kv_heads // M]]
    assert seen["mamba_heads"] == [H // M]
    assert seen["vocab"] == [cfg.vocab_size // M]
    di, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    assert seen["conv"] == [di // M + 2 * N]
    assert seen["cut"] == []
    most = _brought(runs[world], f"brought_train_{mesh}")
    assert most == got["want_bytes"] == lay.step_bytes(
        2, remat=True, backward=True) > 0
    fwd, back = _exchange_count(cfg, M)
    norm = sum(t.numel() * t.element_size() for p, t in _flat_meta(cfg)
               if p.endswith("/mamba/blk/norm")) * (M - 1) // M
    for r in range(M):
        assert lay.step_bytes(2, remat=True, backward=True, rank=r) == \
            2 * (2 * (fwd[r] + norm) + back[r])
    whole = sum(t.numel() * t.element_size() for p, t in _flat_meta(cfg)
                if p.split("/")[-1] in ("w_in", "conv_w", "norm")
                and "/mamba/" in p)
    assert lay.step_bytes_whole(2, remat=True) == \
        2 * 2 * whole * (M - 1) // M
    assert most < lay.step_bytes_whole(2, remat=True)
    assert seen["joined_bytes"] > 0
    assert most + seen["joined_bytes"] == got["want_traffic"]


def _flat_meta(cfg):
    from repro_torch.models import model
    from repro_torch.models.transformer import flatten
    return flatten(model.abstract_params(cfg))


def _exchange_count(cfg, M):
    """For each rank of a model column of M, the bytes of ``w_in`` and
    ``conv_w`` that a forward's exchange brings it and that a backward's
    brings back to it, counted from ``ssm.mamba_columns`` and the plan's
    contiguous chunks: the columns it needs that another rank's chunk
    holds, and the columns of its chunk that another rank needs."""
    from repro_torch.models import ssm
    leaves = dict(_flat_meta(cfg))
    fwd, back = [0] * M, [0] * M
    for name, which in (("w_in", 0), ("conv_w", 1)):
        leaf = leaves[f"layers/mamba/blk/{name}"]
        C = leaf.shape[-1]
        col = leaf.numel() * leaf.element_size() // C
        for r in range(M):
            need = ssm.mamba_columns(cfg.ssm, cfg.d_model, M, r)[which]
            for c in need:
                if c // (C // M) != r:
                    fwd[r] += col
                    back[c // (C // M)] += col
    return fwd, back


def _logits_held(runs, world, tag):
    mine = np.load(runs["dir"] / f"port{world}" / f"logits_{tag}.npy")
    want = np.load(runs["dir"] / "ref" / f"logits_{tag}.npy")
    assert mine.shape == want.shape
    for m, w in zip(mine, want):
        np.testing.assert_allclose(m, w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_dense_plane_at_12_matches_the_reference(runs):
    got = _first(runs[2], "dense_12")
    assert got["tokens"] == runs["ref"]["dense_12"]
    _logits_held(runs, 2, "dense_12")
    lay = _layout("12")
    cfg = _fp32()
    assert got["tp"] == lay.summary() and not got["seq_split"]
    for phase in ("prefill", "decode"):
        seen = got[f"{phase}_seen"]
        assert seen["heads"] == [[2, 2]] and seen["mamba_heads"] == [4]
        assert seen["cut"] == []
        most = _brought([r["brought_dense_12"] for r in runs[2]], phase)
        assert most == got["want_bytes"] == lay.step_bytes(1) > 0
        assert most + seen["joined_bytes"] == got["want_traffic"][phase]
    di, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    P = cfg.ssm.head_dim
    assert got["cache"]["ssm"][-3] == 4 and got["cache"]["k"][-2] == 2
    assert got["cache"]["conv"][-1] == di // 2 + 2 * N
    # the scan's and the decode step's states are the rank's own rows,
    # never gathered: (B, H / M, P, N)
    for phase in ("prefill", "decode"):
        assert got[f"{phase}_seen"]["ssm"] == [[4, 4, P, N]]
        assert got[f"{phase}_seen"]["conv"] == [di // 2 + 2 * N]


LONG_CASES = [("21", 2), ("41", 4), ("22", 4)]


@pytest.mark.parametrize("mesh,world", LONG_CASES,
                         ids=[m for m, _ in LONG_CASES])
def test_b1_decode_holds_its_cache_sequence_over_data(runs, mesh, world):
    """B = 1 on (2, 1), (4, 1), (2, 2): each rank holds Smax / dp of the
    K/V positions (and H / M heads at M = 2), the prefill spans more than
    one slice at dp = 4, the decode crosses a slice boundary at both;
    tokens and every step's logits the reference's serve block's on the
    same mesh."""
    tag = f"long_{mesh}"
    got = _first(runs[world], tag)
    assert got["tokens"] == runs["ref"][tag]
    _logits_held(runs, world, tag)
    dp, M = int(mesh[0]), int(mesh[1])
    assert got["seq_split"]
    sl = 24 // dp
    assert got["cache"]["k"][-3] == got["cache"]["v"][-3] == sl
    assert got["cache"]["k"][-2] == 4 // M
    # the prompt (10) and the decode's positions (10, 11, 12) against the
    # slices: the decode crosses from one slice into the next
    assert len({p // sl for p in (10, 11, 12)}) == 2
    if dp == 4:
        assert 10 > sl
    assert got["prefill_seen"]["mamba_heads"] == [8 // M]


def test_a_b1_context_saved_at_21_resumes_at_11_and_12(runs):
    lines = runs[2]
    ck = [r["ckpt"] for r in lines]
    saved = _first(ck, "saved")
    assert _first(ck, "step") == 2 and _first(ck, "cache")["k"][-3] == 12
    want_next = runs["ref"]["long_21"][3]
    assert want_next == _first(lines, "long_21")["tokens"][3]
    r11 = lines[1]["ckpt"]["resumed_11"]
    assert r11["ctx"] == saved and r11["step"] == 2
    assert r11["cache"]["k"][-3] == 24 and r11["next"] == want_next
    assert "resumed_11" not in lines[0]["ckpt"]
    r12 = _first(ck, "resumed_12")
    assert r12["ctx"] == saved and r12["step"] == 2
    assert r12["cache"]["k"][-3] == 24 and r12["cache"]["k"][-2] == 2
    assert r12["cache"]["ssm"][-3] == 4 and r12["next"] == want_next


def test_a_b1_context_saved_at_21_is_the_references_format(runs):
    """The (2, 1) save holds whole leaves: the JAX package restores it,
    every cache leaf (the positions of both ranks' slices, the Mamba2
    states) bit for bit the saved ones."""
    import jax
    import jax.numpy as jnp
    import repro.configs as JC
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.models import model as jmodel
    from repro.serve import serve_step as jserve
    cfg = dataclasses.replace(JC.get_smoke("zamba2_2p7b"),
                              param_dtype="float32")
    like = {"state": {"params": jmodel.abstract_params(cfg)},
            "step_count": 0,
            "decode": {"cache": jserve.abstract_cache(cfg, 1, 24),
                       "token": jax.ShapeDtypeStruct((1, 1), np.int32),
                       "cache_len": jax.ShapeDtypeStruct((), np.int32)}}
    tree, at = JManager(str(runs["dir"] / "port2"), "long_ckpt").restore(
        like, step=2)
    assert at == 2 and int(tree["decode"]["cache_len"]) == 10 + 2
    saved = np.load(runs["dir"] / "port2" / "long_ckpt_saved.npz")
    flat = jax.tree_util.tree_flatten_with_path(tree["decode"]["cache"])[0]
    assert len(flat) == 4
    for path, leaf in flat:
        name = "/".join(k.key for k in path)
        mine = saved[f"cache/{name}"]
        assert mine.shape == leaf.shape, name
        if name.endswith("conv"):
            # the reference's restore target rounds an fp32 model's conv
            # tail to bf16 (ROADMAP queue 3's noted behaviours)
            mine = np.asarray(jnp.asarray(mine).astype(leaf.dtype))
        np.testing.assert_array_equal(np.asarray(leaf), mine, err_msg=name)


# ------------------------------------------------------------- in process

@pytest.mark.parametrize("window", [0, 5])
def test_chunked_decode_attention_is_the_whole_softmax(window):
    """``decode_attention`` in chunks of positions, and split over
    slices merged as the data ranks merge them, against the one-chunk
    whole softmax (bit for bit the reference's formula): rtol 1e-5 in
    fp32, at positions whose window and mask cut a chunk, a slice whole
    masked among them."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    B, Hq, Hkv, S, D = 2, 4, 2, 40, 8
    q = torch.randn(B, Hq, 1, D, generator=g)
    k = torch.randn(B, Hkv, S, D, generator=g)
    v = torch.randn(B, Hkv, S, D, generator=g)
    for n in (1, 7, 23, 40):
        want = ops.decode_attention(q, k, v, n, sliding_window=window,
                                    chunk=S)
        for chunk in (3, 8, 16):
            got = ops.decode_attention(q, k, v, n, sliding_window=window,
                                       chunk=chunk)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        # four slices of 10 positions, merged as the ranks merge theirs
        parts = [ops.decode_attention(
            q, k[:, :, lo:lo + 10], v[:, :, lo:lo + 10],
            torch.tensor(n), sliding_window=window, offset=lo, chunk=4,
            partials=True) for lo in range(0, S, 10)]
        o, _ = ops.merge_attention(torch.stack([p[0] for p in parts]),
                                   torch.stack([p[1] for p in parts]))
        torch.testing.assert_close(o.reshape(B, Hq, 1, D), want,
                                   rtol=1e-5, atol=1e-6)


def test_one_chunk_is_the_references_decode_attention():
    """With one chunk the port's decode attention is the reference's
    ``ops.decode_attention`` on the same inputs, at 1e-6."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 4, 1, 16, generator=g)
    k = torch.randn(1, 2, 33, 16, generator=g)
    v = torch.randn(1, 2, 33, 16, generator=g)
    for window in (0, 9):
        got = ops.decode_attention(q, k, v, 20, sliding_window=window)
        want = np.asarray(jops.decode_attention(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()), jnp.int32(20), sliding_window=window))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        chunked = ops.decode_attention(q, k, v, 20, sliding_window=window,
                                       chunk=5)
        np.testing.assert_allclose(chunked.numpy(), want, rtol=1e-5,
                                   atol=1e-6)


def test_mamba_columns_are_a_ranks_heads():
    """The columns a rank takes of ``w_in`` and the ``conv`` channels:
    its heads' z, x and dt, and the whole B and C; over the ranks the z,
    x and dt columns cover the leaf once."""
    from repro_torch.models import ssm
    cfg = _fp32()
    di, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.state_dim
    H, P = di // cfg.ssm.head_dim, cfg.ssm.head_dim
    for M in (1, 2, 4):
        seen = []
        for r in range(M):
            cols, chans = ssm.mamba_columns(cfg.ssm, cfg.d_model, M, r)
            assert len(cols) == 2 * di // M + 2 * N + H // M
            assert cols[2 * di // M:2 * di // M + 2 * N] == list(
                range(2 * di, 2 * di + 2 * N))
            assert chans == [c - di for c in cols[di // M:2 * di // M]] \
                + list(range(di, di + 2 * N))
            assert cols[:di // M] == list(range(r * di // M,
                                                (r + 1) * di // M))
            seen += [c for c in cols if not 2 * di <= c < 2 * di + 2 * N]
        assert sorted(seen) == [c for c in range(2 * di + 2 * N + H)
                                if not 2 * di <= c < 2 * di + 2 * N]
        assert P * (H // M) == di // M


# ------------------------------------------------ the columns' exchange

#: a world of gloo ranks on a (1, M) mesh: each ``EXCHANGED`` leaf of
#: the smoke config's layout brought by ``full`` (the exchange) and,
#: from the same whole leaf, gathered whole and cut to the rank's
#: columns (the port's path before the exchange), each given the same
#: cotangent; one JSON line a rank
EXCHANGE = r'''
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, arch = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
import repro_torch.configs as C
from repro_torch.launch.mesh import make_block_mesh
from repro_torch.models import model as model_lib
from repro_torch.sharding import ctx as shard_ctx, plans

over = json.loads(sys.argv[5])         # the smoke config's overrides
heads = over.pop("n_heads", None)
cfg = dataclasses.replace(C.get_smoke(arch), param_dtype="float32", **over)
if heads:
    cfg = dataclasses.replace(cfg, xlstm=dataclasses.replace(
        cfg.xlstm, n_heads=heads))
sizes = {"data": 1, "model": world}
mesh = make_block_mesh(list(range(world)), (1, world), ("data", "model"))
tp = plans.tp_layout(cfg, sizes)
ctx = shard_ctx.ShardCtx(mesh, ("data",), "model", tp=tp)
params = model_lib.abstract_params(cfg)
shapes = dict(plans._dict_leaves(params))
specs = dict(plans._dict_leaves(plans.param_specs(params, sizes)))
out = {"rank": rank}
for path, cols in sorted(tp.exchange.items()):
    keys = tuple(path.split("/"))
    shape = tuple(shapes[keys].shape[1:])           # one group's leaf
    lay = plans.Layout(mesh, plans.to_placements(specs[keys][1:], mesh))
    W = torch.tensor(np.random.default_rng(0).standard_normal(shape),
                     dtype=torch.float32)
    G = torch.tensor(np.random.default_rng(1 + rank).standard_normal(
        shape[:-1] + (len(cols[rank]),)), dtype=torch.float32)
    new, old = (lay.shard(W).requires_grad_(True) for _ in range(2))
    shard_ctx.GATHERED["model_bytes"] = 0
    with shard_ctx.use(ctx):
        got = shard_ctx.full(new, path)
        fwd = shard_ctx.GATHERED["model_bytes"]
        (got * G).sum().backward()
        back = shard_ctx.GATHERED["model_bytes"] - fwd
        want = old.full_tensor(grad_placements=ctx.grad_placements(
            model_partial=True)).index_select(-1, torch.tensor(cols[rank]))
        (want * G).sum().backward()
    chunk = shape[-1] // world
    shared = [c - rank * chunk for c in range(rank * chunk,
                                              (rank + 1) * chunk)
              if sum(c in want_r for want_r in cols) > 1]
    one = [c for c in range(chunk) if c not in shared]
    gn, go = new.grad.to_local(), old.grad.to_local()
    out[path] = {
        "forward_equal": torch.equal(got, want),
        "grad_equal_unshared": torch.equal(gn[..., one], go[..., one]),
        "grad_shared_err": float((gn[..., shared] - go[..., shared]).abs()
                                 .max()) if shared else 0.0,
        "grad_shared_scale": float(go.abs().max()),
        "n_shared": len(shared), "brought": fwd, "brought_back": back,
        "chunk": chunk, "col_bytes": W[..., 0].numel() * W.element_size()}
print("RESULT " + json.dumps(out))
dist.destroy_process_group()
'''


def exchange_world(tmp, world, arch, over=None):
    """``EXCHANGE`` on ``world`` gloo ranks, the smoke config of
    ``arch`` in fp32 with ``over``'s fields (``n_heads``: the xLSTM's):
    each rank's line."""
    script = tmp / "exchange.py"
    script.write_text(EXCHANGE)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(tmp / f"store{world}"), arch, json.dumps(over or {})],
        cwd=str(tmp),
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    return _collect(procs, time.time() + 120)


def held_exchange(lines, cfg, M):
    """The exchange's forward bit for bit the whole gather's columns;
    its gradient the whole leaf's summed over the column, on the rank's
    chunk: bit for bit where one rank computes with a column, within
    fp32 roundoff (M ulp of the largest) where the M ranks do; the bytes
    it brought each rank, forward and back, the columns counted from
    the layout's lists."""
    from repro_torch.sharding import plans
    lay = plans.tp_layout(cfg, {"data": 1, "model": M})
    assert lay.exchange and len(lines) == M
    for line in lines:
        r = line["rank"]
        for path, cols in lay.exchange.items():
            got = line[path]
            assert got["forward_equal"] and got["grad_equal_unshared"], path
            assert got["grad_shared_err"] <= M * 2 ** -23 * \
                got["grad_shared_scale"], (path, got)
            chunk = got["chunk"]
            lack = sum(1 for c in cols[r] if c // chunk != r)
            owed = sum(1 for s, want in enumerate(cols) if s != r
                       for c in want if c // chunk == r)
            assert got["brought"] == lack * got["col_bytes"], path
            assert got["brought_back"] == owed * got["col_bytes"], path
    return lay


@pytest.mark.parametrize("world", [2, 4])
def test_the_exchange_is_the_whole_gathers_columns(tmp_path, world):
    """On 2 and 4 gloo ranks, zamba2's smoke ``w_in`` and ``conv_w``
    through the exchange against gathered whole and cut: forward bit
    for bit, the gradient on each rank's chunk bit for bit for z, x and
    dt, within fp32 roundoff for B and C, which every rank reads."""
    cfg = _fp32()
    lines = exchange_world(tmp_path, world, "zamba2_2p7b")
    lay = held_exchange(lines, cfg, world)
    assert set(lay.exchange) == {"layers/mamba/blk/w_in",
                                 "layers/mamba/blk/conv_w"}
    # B and C are the columns every rank reads, held by the last rank(s)
    N = cfg.ssm.state_dim
    assert sum(line["layers/mamba/blk/w_in"]["n_shared"]
               for line in lines) == 2 * N


def test_a_leaf_whose_columns_do_not_divide_is_not_exchanged():
    """With a state width N of 1, ``w_in``'s 2 d_inner + 2 + H columns
    and ``conv_w``'s d_inner + 2 channels do not divide by M = 4, so the
    plan replicates them over ``model``: the layout exchanges neither,
    nothing of them comes over ``model`` (only the gated norm's
    ``norm``), and the forward cuts the rank's columns from the whole
    leaf itself (``ssm._take``)."""
    from repro_torch.models import ssm
    from repro_torch.sharding import plans
    base = _fp32()
    cfg = dataclasses.replace(base, ssm=dataclasses.replace(base.ssm,
                                                            state_dim=1))
    M = 4
    lay = plans.tp_layout(cfg, {"data": 1, "model": M})
    assert "mamba" in lay.kinds and not lay.exchange
    names = {"layers/mamba/blk/w_in", "layers/mamba/blk/conv_w"}
    assert names <= lay.partial
    from repro_torch.models import model
    specs = dict(plans._dict_leaves(plans.param_specs(
        model.abstract_params(cfg), {"data": 1, "model": M})))
    assert all("model" not in specs[tuple(n.split("/"))] for n in names)
    norm = sum(t.numel() * t.element_size() for p, t in _flat_meta(cfg)
               if p.endswith("/mamba/blk/norm")) * (M - 1) // M
    assert lay.step_bytes(1) == lay.step_bytes_whole(1) == norm
    di = cfg.ssm.expand * cfg.d_model
    cols, _ = ssm.mamba_columns(cfg.ssm, cfg.d_model, M, 1)
    whole = torch.randn(cfg.d_model, 2 * di + 2 + di // cfg.ssm.head_dim,
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(ssm._take(whole, cols), whole[:, cols])
    mine = whole[:, cols]
    assert ssm._take(mine, cols) is mine    # an exchanged leaf, as it came


ZAMBA_MESHES = [2, 4, 8, 16]


@pytest.mark.parametrize("M", ZAMBA_MESHES)
def test_zamba2_full_width_exchange_bytes(M):
    """zamba2_2p7b at full width on a (1, M) mesh, abstract params: the
    bytes the layout counts over ``model``, forward and back, are a
    direct count from ``ssm.mamba_columns`` and the plan's chunks (and
    the gathered ``norm``), below the whole gather's; a rank holds its
    columns of a group, not the whole; at (1, 16) a decode step of 4
    rows brings at most 0.25 GB over ``model`` (computed)."""
    import repro_torch.configs as C
    from repro_torch.launch.hlo_analysis import tp_traffic
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding import plans
    cfg = C.get("zamba2_2p7b")
    lay = plans.tp_layout(cfg, {"data": 1, "model": M})
    fwd, back = _exchange_count(cfg, M)
    assert list(lay.exchange_in) == fwd and list(lay.exchange_back) == back
    norm = sum(t.numel() * t.element_size() for p, t in _flat_meta(cfg)
               if p.endswith("/mamba/blk/norm")) * (M - 1) // M
    assert lay.bytes_top == 0
    assert lay.step_bytes(1) == max(fwd) + norm < lay.step_bytes_whole(1)
    assert lay.step_bytes(2, remat=True, backward=True) == max(
        2 * (2 * (f + norm) + b) for f, b in zip(fwd, back))
    assert lay.group_bytes < lay.group_bytes_whole
    shape, mesh = ShapeConfig("d", "decode", 1, 4), {"data": 1, "model": M}
    decode = tp_traffic(cfg, shape, mesh)["8d"]
    whole = tp_traffic(cfg, shape, mesh, exchange=False)["8d"]
    assert decode < whole
    if M == 16:
        assert 0.15e9 < decode <= 0.25e9 < 2.2e9 < whole


# ------------------------------------------------------------ chip_smoke

def test_chip_smoke_hybrid_sharded_and_serve_long_phases_on_cpu():
    """``chip_smoke.py``'s hybrid_sharded and serve_long phases at smoke
    size on the CPU (gloo, one rank): the sharded train block's losses,
    grad norms and launches train_hybrid's, the sharded serve block's
    tokens and logits serve_hybrid's, bit for bit; serve_long's sharded
    B = 1 run the unsharded one's, the chunked decode attention the
    whole softmax's, the dry run's line for the same cell; the process
    group destroyed after each."""
    root = os.path.join(os.path.dirname(__file__), "..")
    code = f"""
import sys
sys.path.insert(0, {os.path.abspath(root)!r})
import torch
torch.set_num_threads(1)
import chip_smoke as c
train = c.phase_train_hybrid(device="cpu", smoke=True)
serve = c.phase_serve_hybrid(device="cpu", smoke=True)
out = c.phase_hybrid_sharded(device="cpu", smoke=True, train=train,
                             serve=serve)
t, s = out["train"], out["serve"]
assert t["losses_equal_train_hybrid"] and t["grad_norms_equal_train_hybrid"]
assert t["tp"]["sharded"] == ["attn", "mamba", "mlp", "vocab"]
assert s["tokens_equal_serve_hybrid"] and s["logits_equal_serve_hybrid"]
assert s["launches_equal_serve_hybrid"]
import torch.distributed as dist
assert not dist.is_initialized()
long = c.phase_serve_long(device="cpu", smoke=True)
assert long["tokens_equal_unsharded"] and long["logits_digests_equal_unsharded"]
assert long["sharded"]["sharded"] and not long["unsharded"]["sharded"]
assert long["attention_check"]["passed"]
assert long["attention_check"]["chunks"] == 4
assert long["dryrun"]["gaps"] == []
assert not dist.is_initialized()
print("HYBRID_PHASES_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=ENV, cwd=root)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "HYBRID_PHASES_OK" in r.stdout
