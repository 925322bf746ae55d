"""MLA's heads over ``model`` and its compressed cache's sequence over
``data`` (item 8g, part 2) on gloo ranks on the CPU, against the JAX
package's runs on the same mesh shapes.

The reference runs in two subprocesses with 4 forced host devices each,
at once (``REF``, parts "train" and "serve"): the train part runs
deepseek_v2_236b's smoke config in fp32 (4 MLA heads, 8 routed experts
top-2 and 2 shared) at (1, 2), (2, 2) and (1, 4), 3 steps each from its
own init, saving every step; the serve part saves two serve blocks'
inits, then prefills a 4 x 16 prompt and decodes 3 greedy steps on the
dense plane at (1, 2), and a 1 x 10 prompt into a cache of 24
positions, decoding 3 steps (positions 10, 11, 12), at (1, 1).  The
reference cannot run that B = 1 job on 2 or 4 data ranks: under a
context its MoE layers route one group a data rank (a ``shard_map``
over ``data``), and one token's decode does not split over them.  So
the B = 1 job runs at capacity factor 16, where no choice is dropped
and routing groups of any size give the same experts (``long_cfg``),
and the port's runs at (2, 1), (4, 1) and (2, 2) are held to the
reference's one-device run.  At dp = 2 the slices are 12 positions and
at dp = 4 six: the prompt spans two ranks' slices at dp = 4, and the
decode crosses from one slice into the next at both.  The port's worlds
of 4 and 2 gloo ranks (``RANKS``) restore those checkpoints as they
land, run the same steps and traffic on their meshes and print one JSON
line each.

Held, with ``tests/test_torch_hybrid_parallel.py``'s tolerances:
* train: losses and grad norms at rtol 1e-4 over 3 free-running steps,
  the params after 3 steps at atol 2e-3;
* serve: greedy tokens equal, prefill and every decode step's logits
  within 1e-4 of their largest magnitude;
* what each rank computes: flash and the absorbed decode see H / M
  heads, the expert products E / M experts, the loss V / M of the
  vocabulary; the compressed cache holds, at dp > 1 with B = 1, Smax /
  dp positions; the bytes ``full`` brings over ``model`` (none: the
  down-projections and their norms are replicated over ``model``) and
  the joins' bytes as ``plans.TPLayout`` and ``hlo_analysis.tp_traffic``
  compute them;
* a context saved at (2, 1) (each rank a slice of the positions)
  resumes at (1, 1) and (1, 2): its whole leaves bit for bit, the next
  token the uninterrupted run's; the JAX package restores the saved
  files, every leaf bit for bit;
* in process: the layout rule at M = 2, 4, 8 and 16, and the absorbed
  decode's attention split over slices and merged as the data ranks
  merge it, against the whole softmax;
* ``chip_smoke.py``'s ``moe_sharded`` and ``serve_long_mla`` at smoke
  size.
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

V2 = "deepseek_v2_236b"
TRAIN = ((1, 2), (2, 2), (1, 4))
PROMPT, GEN = 16, 3
LONG_P, LONG_SMAX = 10, 24
LONG = ((2, 1), (4, 1), (2, 2))


def fp32(C):
    return dataclasses.replace(C.get_smoke(V2), param_dtype="float32")


def train_setup(Shape, Opt):
    return (Shape("t", "train", seq_len=32, global_batch=4, microbatch=2),
            Opt(warmup_steps=1, total_steps=4))


def dense_job(C, Job, Shape):
    return Job(fp32(C), Shape("s", "serve", seq_len=PROMPT + GEN + 1,
                              global_batch=4),
               kind="serve", ckpt_namespace="serve_dense")


def long_cfg(C):
    """The B = 1 runs' config: the reference routes a MoE layer's tokens
    in one group a data rank under a context and cannot split one
    token's decode over 2 or 4 of them, so it runs these at (1, 1); at
    capacity factor 16 no choice is dropped, so routing groups of any
    size give the same experts and the port's runs on those meshes hold
    to it."""
    cfg = fp32(C)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))


def long_job(C, Job, Shape, ns="serve_long"):
    return Job(long_cfg(C), Shape("s", "serve", seq_len=LONG_SMAX,
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
    res["long_11"] = serve(long_job(C, JobSpec, ShapeConfig), (1, 1), 1,
                           LONG_P, "long_11")
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
from repro_torch.models import layers, moe
from repro_torch.models import model as model_lib
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import flatten
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.train import optimizer as opt_lib
from torch.distributed.tensor import DTensor

res = {}
SEEN = {"heads": set(), "decode_heads": set(), "positions": set(),
        "experts": set(), "vocab": set()}


def tapped(fn, note):
    def wrapper(*a, **kw):
        note(*a, **kw)
        return fn(*a, **kw)
    return wrapper


ops.flash_attention = tapped(
    ops.flash_attention,
    lambda q, k, *_, **__: SEEN["heads"].add((q.shape[1], k.shape[1])))
layers.mla_decode_attention = tapped(
    layers.mla_decode_attention, lambda q_abs, q_rope, c, *_, **__: (
        SEEN["decode_heads"].add(q_abs.shape[1]),
        SEEN["positions"].add(c.shape[1])))
moe._experts = tapped(moe._experts, lambda p, *_: SEEN["experts"].add(
    p["w_gate"].shape[0]))
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
            "model_bytes": shard_ctx.GATHERED["model_bytes"],
            "joined_bytes": shard_ctx.JOINED["model_bytes"]}


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
    out = {"tp": rt.tp.summary(), "seen": observed(),
           "want_bytes": rt.tp.step_bytes(shape.microbatch, remat=True),
           "want_traffic": traffic(rt.job.cfg, shape, mesh),
           "partial": sorted(rt.tp.partial)}
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
    out = {"prefill_seen": observed(), "want_bytes": rt.tp.step_bytes(1),
           "seq_split": rt.ctx.seq_split, "cache": cache_shapes(rt)}
    if B % mesh[0] == 0:
        out["want_traffic"] = {
            "prefill": traffic(rt.job.cfg, ShapeConfig(
                "p", "prefill", P, B), mesh),
            "decode": traffic(rt.job.cfg, ShapeConfig(
                "d", "decode", 1, B), mesh)}
    rows = [box["logits"]]
    toks = [tokens(rt)]
    LOGITS.clear()
    for i in range(gen):
        observe()
        rt.step()
        if i == 0:
            out["decode_seen"] = observed()
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
            observe()
            seen[name] = {"ctx": ctx_digests(rt), "step": rt.step_count,
                          "cache": cache_shapes(rt)}
            rt.step()
            seen[name]["next"] = tokens(rt)
            seen[name]["seen"] = observed()
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
    tmp = tmp_path_factory.mktemp("mla_parallel")
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
    return dataclasses.replace(C.get_smoke("deepseek_v2_236b"),
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
    atol 2e-3 (the MLA down-projections among them, whose gradients are
    each rank's part summed over the model column)."""
    got = _first(runs[world], f"train_{mesh}")
    want = np.asarray(runs["ref"][f"train_{mesh}"])
    np.testing.assert_allclose(got["free"], want, rtol=1e-4)
    import jax
    import repro.configs as JC
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.train import optimizer as jopt
    from repro.train import train_step as jtrain
    cfg = dataclasses.replace(JC.get_smoke("deepseek_v2_236b"),
                              param_dtype="float32")
    opt = jopt.OptConfig(warmup_steps=1, total_steps=4)
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


@pytest.mark.parametrize("mesh,world", TRAIN_CASES,
                         ids=[m for m, _ in TRAIN_CASES])
def test_each_rank_computes_its_share_of_mla(runs, mesh, world):
    """Flash sees H / M heads (q and the per-head K), the expert
    products E / M experts, the loss V / M of the vocabulary; the MLA
    down-projections and their norms are the layout's partial leaves;
    ``full`` brings nothing over ``model`` (every leaf the plan puts on
    ``model`` computes sharded), and the joins bring what ``tp_traffic``
    computes."""
    got = _first(runs[world], f"train_{mesh}")
    lay = _layout(mesh)
    cfg = _fp32()
    M = int(mesh[1])
    assert got["tp"] == lay.summary() and lay.kept == ()
    assert lay.kinds == {"attn", "experts", "shared", "vocab"}
    assert got["partial"] == sorted(
        f"layers/attn/{n}" for n in ("wq_a", "q_norm", "wkv_a", "kv_norm"))
    seen = got["seen"]
    H = cfg.attention.n_heads
    assert seen["heads"] == [[H // M, H // M]]
    assert seen["experts"] == [cfg.moe.n_experts // M]
    assert seen["vocab"] == [cfg.vocab_size // M]
    assert seen["model_bytes"] == got["want_bytes"] == 0
    assert seen["joined_bytes"] == got["want_traffic"] > 0


def _flat_meta(cfg):
    from repro_torch.models import model
    from repro_torch.models.transformer import flatten
    return flatten(model.abstract_params(cfg))


def test_a_ranks_group_holds_its_heads_of_mla():
    """At M = 2 a rank's gathered group holds half of ``wq_b``, ``wk_b``,
    ``wv_b``, ``wo`` and of the experts and shared expert, and the whole
    of the down-projections, their norms, the sublayer norms and the
    router."""
    cfg = _fp32()
    lay = _layout("12")
    half = {"wq_b", "wk_b", "wv_b", "wo", "w_gate", "w_up", "w_down"}
    want = 0
    for path, t in _flat_meta(cfg):
        if not path.startswith("layers/"):
            continue
        n = t.numel() * t.element_size() // cfg.n_layers
        want += n // 2 if path.split("/")[-1] in half else n
    assert lay.group_bytes == want < lay.group_bytes_whole


def _logits_held(runs, world, tag, ref_tag=None):
    mine = np.load(runs["dir"] / f"port{world}" / f"logits_{tag}.npy")
    want = np.load(runs["dir"] / "ref" / f"logits_{ref_tag or tag}.npy")
    assert mine.shape == want.shape
    for m, w in zip(mine, want):
        np.testing.assert_allclose(m, w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_dense_plane_at_12_matches_the_reference(runs):
    got = _first(runs[2], "dense_12")
    assert got["tokens"] == runs["ref"]["dense_12"]
    _logits_held(runs, 2, "dense_12")
    lay = _layout("12")
    assert got["tp"] == lay.summary() and not got["seq_split"]
    assert got["prefill_seen"]["heads"] == [[2, 2]]
    assert got["decode_seen"]["decode_heads"] == [2]
    assert got["decode_seen"]["positions"] == [16 + 3 + 1]
    for phase in ("prefill", "decode"):
        seen = got[f"{phase}_seen"]
        assert seen["model_bytes"] == got["want_bytes"] == 0
        assert seen["joined_bytes"] == got["want_traffic"][phase] > 0
    # the compressed cache has no heads: each rank holds it whole
    assert got["cache"]["c_kv"][-2:] == [20, 16]
    assert got["cache"]["k_rope"][-2:] == [20, 8]


LONG_CASES = [("21", 2), ("41", 4), ("22", 4)]


@pytest.mark.parametrize("mesh,world", LONG_CASES,
                         ids=[m for m, _ in LONG_CASES])
def test_b1_decode_holds_its_compressed_cache_sequence_over_data(
        runs, mesh, world):
    """B = 1 on (2, 1), (4, 1), (2, 2): each rank holds Smax / dp of the
    compressed positions (and computes H / M heads at M = 2), the prefill
    spans more than one slice at dp = 4, the decode crosses a slice
    boundary at both; tokens and every step's logits the reference's
    serve block's at (1, 1) (``long_cfg``)."""
    tag = f"long_{mesh}"
    got = _first(runs[world], tag)
    assert got["tokens"] == runs["ref"]["long_11"]
    _logits_held(runs, world, tag, "long_11")
    dp, M = int(mesh[0]), int(mesh[1])
    assert got["seq_split"]
    sl = 24 // dp
    assert got["cache"]["c_kv"][-2] == got["cache"]["k_rope"][-2] == sl
    assert got["decode_seen"]["positions"] == [sl]
    assert got["decode_seen"]["decode_heads"] == [4 // M]
    assert got["prefill_seen"]["heads"] == [[4 // M, 4 // M]]
    # the prompt (10) and the decode's positions (10, 11, 12) against the
    # slices: the decode crosses from one slice into the next
    assert len({p // sl for p in (10, 11, 12)}) == 2
    if dp == 4:
        assert 10 > sl


def test_a_b1_context_saved_at_21_resumes_at_11_and_12(runs):
    lines = runs[2]
    ck = [r["ckpt"] for r in lines]
    saved = _first(ck, "saved")
    assert _first(ck, "step") == 2 and _first(ck, "cache")["c_kv"][-2] == 12
    want_next = runs["ref"]["long_11"][3]
    assert want_next == _first(lines, "long_21")["tokens"][3]
    r11 = lines[1]["ckpt"]["resumed_11"]
    assert r11["ctx"] == saved and r11["step"] == 2
    assert r11["cache"]["c_kv"][-2] == 24 and r11["next"] == want_next
    assert "resumed_11" not in lines[0]["ckpt"]
    r12 = _first(ck, "resumed_12")
    assert r12["ctx"] == saved and r12["step"] == 2
    assert r12["cache"]["c_kv"][-2] == 24 and r12["next"] == want_next
    assert r12["seen"]["decode_heads"] == [2]


def test_a_b1_context_saved_at_21_is_the_references_format(runs):
    """The (2, 1) save holds whole leaves: the JAX package restores it,
    both compressed leaves (the positions of both ranks' slices) bit for
    bit the saved ones."""
    import jax
    import repro.configs as JC
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.models import model as jmodel
    from repro.serve import serve_step as jserve
    cfg = dataclasses.replace(JC.get_smoke("deepseek_v2_236b"),
                              param_dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))
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
    assert len(flat) == 2
    for path, leaf in flat:
        name = "/".join(k.key for k in path)
        mine = saved[f"cache/{name}"]
        assert mine.shape == leaf.shape, name
        np.testing.assert_array_equal(np.asarray(leaf), mine, err_msg=name)
        # the prompt's and the two decode steps' rows, then zeros
        assert np.abs(mine[..., :12, :]).max(axis=-1).min() > 0
        assert not mine[..., 12:, :].any()


# ------------------------------------------------------------- in process

def test_the_layout_rule_splits_mla_by_head():
    """deepseek_v2_236b at full width computes its attention sharded at
    M = 2, 4 and 16 and keeps nothing; where the heads do not divide by
    M the named rule keeps MLA whole; a B = 1 serve cache splits its
    positions over 2 or more data ranks."""
    import repro_torch.configs as C
    from repro_torch.sharding import plans
    full = C.get("deepseek_v2_236b")
    for M in (2, 4, 16):
        lay = plans.tp_layout(full, {"data": 1, "model": M})
        assert lay.kinds == {"attn", "experts", "shared", "vocab"}
        assert lay.kept == () and lay.heads == (128 // M, 128 // M)
        assert lay.bytes_groups == 0 and len(lay.partial) == 4
    smoke = plans.tp_layout(C.get_smoke("deepseek_v2_236b"),
                            {"data": 1, "model": 8})
    assert smoke.kept == ("mla: heads 4 % 8",)
    assert "attn" not in smoke.kinds and not smoke.partial
    assert smoke.heads == (4, 4)
    for dp in (2, 4, 16):
        assert plans.seq_splits(full, 1, 32768, dp)
    assert not plans.seq_splits(full, 1, 32768, 1)
    assert not plans.seq_splits(full, 4, 32768, 2)


def test_the_compressed_cache_layout_is_the_references_spec():
    """``cache_layouts(seq=True)`` puts ``c_kv``'s and ``k_rope``'s
    sequence dim over ``data`` and nothing over ``model``: the
    reference's ``cache_specs`` ``(3, 2, None)`` for a batch of 1."""
    import repro_torch.configs as C
    from repro_torch.models import model
    from repro_torch.models.transformer import flatten
    from repro_torch.sharding import plans
    from torch.distributed.tensor import Replicate, Shard
    cfg = C.get_smoke("deepseek_v2_236b")
    mesh = {"data": 2, "model": 2}
    cache = model.init_cache(cfg, 1, 24, "meta")
    tp = plans.tp_layout(cfg, mesh)
    lays = dict(flatten(plans.cache_layouts(cache, mesh, split=False,
                                            tp=tp, seq=True)))
    specs = plans.cache_specs(cache, cfg, mesh, batch_size=1)
    assert set(specs) == {"c_kv", "k_rope"}
    for path, leaf in flatten(cache):
        assert lays[path].placements == (Shard(leaf.ndim - 2), Replicate())
        assert specs[path] == (None, None, "data", None)


def test_merged_absorbed_decode_is_the_whole_softmax():
    """``layers.mla_decode_attention`` over slices of the compressed
    cache, each with its offset, merged as the data ranks merge them
    (``ops.merge_attention``), against one call over the whole cache:
    the fp32 partials (normalised output and log-sum-exp) at rtol 1e-5,
    a slice wholly masked among them; one slice is the whole bit for
    bit."""
    from repro_torch.kernels import ops
    from repro_torch.models.layers import mla_decode_attention
    g = torch.Generator().manual_seed(0)
    B, H, R, Dr, S = 2, 4, 16, 8, 40
    q_abs = torch.randn(B, H, 1, R, generator=g)
    q_rope = torch.randn(B, H, 1, Dr, generator=g)
    c = torch.randn(B, S, R, generator=g)
    r = torch.randn(B, S, Dr, generator=g)
    for n in (1, 7, 23, 40):
        want = mla_decode_attention(q_abs, q_rope, c, r, torch.tensor(n),
                                    0.25, partials=True)
        one = mla_decode_attention(q_abs, q_rope, c, r, torch.tensor(n),
                                   0.25, offset=0, partials=True)
        o, lse = ops.merge_attention(one[0][None], one[1][None])
        assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
        parts = [mla_decode_attention(
            q_abs, q_rope, c[:, lo:lo + 10], r[:, lo:lo + 10],
            torch.tensor(n), 0.25, offset=lo, partials=True)
            for lo in range(0, S, 10)]
        o, lse = ops.merge_attention(torch.stack([p[0] for p in parts]),
                                     torch.stack([p[1] for p in parts]))
        torch.testing.assert_close(o, want[0], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(lse, want[1], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ chip_smoke

def test_chip_smoke_moe_sharded_and_serve_long_mla_phases_on_cpu():
    """``chip_smoke.py``'s moe_sharded and serve_long_mla phases at smoke
    size on the CPU (gloo, one rank): the sharded serve block's tokens
    and logits serve_moe's, the sharded train block's losses, grad norms
    and launches train_moe's, bit for bit, MLA on the tensor-parallel
    path; serve_long_mla's sharded B = 1 run on the sequence-split path
    (``seq_split`` true at one data rank) the unsharded one's, the merged
    absorbed decode the whole softmax's, the dry run's line for the same
    cell; the process group destroyed after each."""
    root = os.path.join(os.path.dirname(__file__), "..")
    code = f"""
import sys
sys.path.insert(0, {os.path.abspath(root)!r})
import torch
torch.set_num_threads(1)
import chip_smoke as c
serve = c.phase_serve_moe(device="cpu", smoke=True)
train = c.phase_train_moe(device="cpu", smoke=True)
out = c.phase_moe_sharded(device="cpu", smoke=True, serve=serve,
                          train=train)
s, t = out["serve"], out["train"]
for k in ("tokens", "logits", "launches", "launches_per_replay"):
    assert s[k + "_equal_serve_moe"], k
for k in ("losses", "grad_norms", "launches_per_step"):
    assert t[k + "_equal_train_moe"], k
assert s["tp"]["sharded"] == ["attn", "experts", "shared", "vocab"]
assert t["tp"]["kept_8a"] == []
import torch.distributed as dist
assert not dist.is_initialized()
long = c.phase_serve_long_mla(device="cpu", smoke=True)
assert long["tokens_equal_unsharded"] and long["logits_digests_equal_unsharded"]
assert long["sharded"]["seq_split"] and not long["unsharded"]["sharded"]
assert long["attention_check"]["passed"]
assert long["dryrun"]["gaps"] == []
assert not dist.is_initialized()
print("MLA_PHASES_OK")
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=ENV, cwd=root)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "MLA_PHASES_OK" in r.stdout
