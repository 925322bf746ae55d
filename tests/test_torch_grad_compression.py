"""The port's compressed cross-pod all-reduce (item 9) against the JAX
package's, on the CPU.

* The codec (``quantize``, ``dequantize``, ``compress_residual``,
  ``init_error_feedback``) against the reference's functions in process,
  bit for bit: fp32 and bf16 inputs, an all-zero leaf (scale 1.0), exact
  .5 ties (both round half to even) and values at the +-127 clamp.
* ``compressed_allreduce`` on 2 gloo ranks (a ``(2, 1, 1)`` ``("pod",
  "data", "model")`` mesh, one pod a rank) against the
  reference's on an 8-device XLA subprocess (a ``(2, 2, 2)`` mesh, as
  ``tests/test_multidevice.py`` builds it), bit for bit; and on 4 gloo
  ranks with each pod's leaf sharded over ``data`` (DTensors), where the
  shared scale must be the whole leaf's.
* ``make_train_step(overlap_comm=True)`` on 4 gloo ranks, ``(2, 2, 1)``,
  deepseek_7b's smoke config in fp32, 2 microbatches: its one-step
  gradient, before the optimizer, equals the reference's
  ``compressed_allreduce`` applied microbatch by microbatch to the port's
  own per-pod gradients with the error carried (bit for bit); every
  pod's params stay bitwise equal over 3 steps; its losses track the
  port's serial path on the same mesh within rtol/atol 0.05 (the
  reference's own bound, ``tests/test_train.py``); the pod reduce of a
  microbatch is issued after its backward and waited on after the next
  microbatch's; llama4_maverick_400b's smoke config (MoE, routing per
  (microbatch, pod, data shard)) runs through it with its pods in sync.

The reference's own overlapped step cannot run on this tree (its
``shard_map(check_rep=)`` fails under jax 0.9), so the step is held
against the reference's reducer applied to the port's gradients.  The
ranks are subprocesses joined through a ``FileStore`` in the test's
directory, each with ``torch.set_num_threads(1)`` and its own timeout.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import grad_compression as jgc  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.sharding import ctx as shard_ctx  # noqa: E402
from repro_torch.train import grad_compression as gc  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402
from repro_torch.train import train_step as train_lib  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu")

torch.set_num_threads(1)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8) if a.dtype.itemsize == 1 else \
        a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _case(name):
    """(fp32 values, dtype) of one codec case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "zeros":
        return np.zeros((4, 33), np.float32), "f32"
    if name == "ties":
        # every element at (k + 0.5) * s, the leaf's absmax 127 * s
        s = np.float32(0.0625)
        x = (rng.integers(-126, 126, (300,)) + 0.5).astype(np.float32) * s
        x[7] = 127 * s
        return x, "f32"
    if name == "clamp":
        # absmax's neighbours: codes at +-127 and just under
        x = rng.standard_normal((5, 64)).astype(np.float32)
        x[0, :4] = [x.__abs__().max(), -x.__abs__().max(), 3.9e3, -3.9e3]
        return x, "f32"
    x = (rng.standard_normal((3, 7, 129)) * 1e-3).astype(np.float32)
    return x, ("bf16" if name == "bf16" else "f32")


def _both(x, dt):
    if dt == "bf16":
        return (jnp.asarray(x, jnp.bfloat16),
                torch.from_numpy(x).to(torch.bfloat16))
    return jnp.asarray(x), torch.from_numpy(x)


CASES = ["f32", "bf16", "zeros", "ties", "clamp"]


@pytest.mark.parametrize("name", CASES)
def test_quantize_and_dequantize_bit_for_bit(name):
    x, dt = _case(name)
    jx, tx = _both(x, dt)
    jc, js = jgc.quantize(jx)
    tc, ts = gc.quantize(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert _bits(ts.numpy()) == _bits(np.float32(js))
    np.testing.assert_array_equal(
        _bits(gc.dequantize(tc, ts).numpy()),
        _bits(jgc.dequantize(jc, js)))
    if name == "zeros":
        assert float(ts) == 1.0 and not tc.any()
    if name == "ties":
        # half to even: every tie lands on an even code
        assert (tc.numpy().astype(np.int32) % 2 == 0).sum() >= 290
    if name == "clamp":
        assert int(tc.abs().max()) == 127


@pytest.mark.parametrize("name", CASES)
def test_compress_residual_bit_for_bit(name):
    x, dt = _case(name)
    e = (np.random.default_rng(3).standard_normal(x.shape)
         * 1e-5).astype(np.float32)
    jx, tx = _both(x, dt)
    jc, js, je = jgc.compress_residual(jx, jnp.asarray(e))
    tc, ts, te = gc.compress_residual(tx, torch.from_numpy(e))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert _bits(ts.numpy()) == _bits(np.float32(js))
    np.testing.assert_array_equal(_bits(te.numpy()), _bits(je))


def test_init_error_feedback_matches_the_reference():
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": ()}}
    jp = jax.tree.map(lambda s: jnp.ones(s, jnp.bfloat16), shapes,
                      is_leaf=lambda s: isinstance(s, tuple))
    tp = {"a": torch.ones(3, 4, dtype=torch.bfloat16),
          "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                "d": torch.ones((), dtype=torch.bfloat16)}}
    want = jgc.init_error_feedback(jp)
    got = gc.init_error_feedback(tp)
    for path in (("a",), ("b", "c"), ("b", "d")):
        w, g = want, got
        for k in path:
            w, g = w[k], g[k]
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert not g.any() and not np.asarray(w).any()


def test_overlap_comm_requires_a_pod_axis():
    """As the reference's ``test_train_step_overlap_comm_requires_pod_axis``:
    no mesh, or a mesh without the pod axis, is an assertion."""
    import repro_torch.configs as C
    cfg = C.get_smoke("deepseek_7b")
    shape = ShapeConfig("t", "train", seq_len=32, global_batch=4,
                        microbatch=2)
    with pytest.raises(AssertionError):
        train_lib.make_train_step(cfg, shape, opt_lib.OptConfig(),
                                  overlap_comm=True, mesh=None)

    class Mesh:                         # a mesh's names, no pod axis
        mesh_dim_names = ("data", "model")
    with pytest.raises(AssertionError):
        train_lib.make_train_step(cfg, shape, opt_lib.OptConfig(),
                                  overlap_comm=True, mesh=Mesh())


def test_pod_bytes_are_the_int8_all_gathers():
    """(n - 1) bytes an element over the pods, and the scales' ring MAX
    all-reduce over the block; the reference's int32 psum of the same
    codes would move 2 (n - 1) / n x 4 an element, fp32's bytes."""
    got = gc.pod_bytes(1000, 3, 2, 8)
    assert got == {"payload": 1000, "scales": 2 * 7 * 4 * 3 // 8}
    assert gc.pod_bytes(1000, 3, 8, 8)["payload"] == 7000
    assert 2 * (2 - 1) * 4 * 1000 // 2 == 4 * got["payload"]


# ------------------------------------------------- across processes

CODEC_IN = {"a": ((2, 64), "f32"), "b": ((2, 4, 8), "bf16"),
            "z": ((2, 16), "zero")}


def _codec_inputs():
    rng = np.random.default_rng(11)
    g, e = {}, {}
    for k, (shape, kind) in CODEC_IN.items():
        x = rng.standard_normal(shape).astype(np.float32)
        if kind == "zero":
            x = np.zeros(shape, np.float32)
        if kind == "bf16":
            x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        g[k] = x
        e[k] = (rng.standard_normal(shape) * 1e-3).astype(np.float32) \
            if kind != "zero" else np.zeros(shape, np.float32)
    return g, e


REF = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.train import grad_compression as gc

out = sys.argv[1]
z = np.load(f"{out}/codec_in.npz")
kinds = json.loads(sys.argv[2])


def cast(k, x):
    return jnp.asarray(x, jnp.bfloat16) if kinds[k] == "bf16" else \
        jnp.asarray(x)


mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
g = {k: cast(k, z["g/" + k]) for k in kinds}
e = {k: jnp.asarray(z["e/" + k]) for k in kinds}
red, new = gc.compressed_allreduce(g, e, mesh, "pod")
res = {f"red/{k}": np.asarray(v) for k, v in red.items()}
res.update({f"err/{k}": np.asarray(v) for k, v in new.items()})

# the overlapped step's expectation: the reference's reducer applied to
# the port's per-pod gradients microbatch by microbatch, the error carried
pod_mesh = jax.make_mesh((2,), ("pod",))
grads = [np.load(f"{out}/pod_grads_mb{i}.npz") for i in range(2)]
paths = grads[0].files
err = {p: jnp.zeros(grads[0][p].shape, jnp.float32) for p in paths}
acc = {p: np.zeros(grads[0][p].shape[1:], np.float32) for p in paths}
for mb in grads:
    red, err = gc.compressed_allreduce(
        {p: jnp.asarray(mb[p]) for p in paths}, err, pod_mesh, "pod")
    for p in paths:
        r = np.asarray(red[p])
        assert np.array_equal(r[0], r[1]), p
        acc[p] = acc[p] + r[0]
res.update({f"step/{p}": acc[p] / np.float32(2) for p in paths})
np.savez(f"{out}/ref_out.npz", **res)

# the overlapped step with int8 moments, step by step from the port's
# state before each: the reference's reducer on the port's per-pod
# gradients, the error carried, then the reference's jitted int8 AdamW
import functools, pickle
from repro.train import optimizer as jopt
W = [pickle.load(open(f"{out}/witness_r{r}.pkl", "rb")) for r in range(2)]
wpaths = W[0]["paths"]


def nest(flat):
    tree = {}
    for p, v in flat.items():
        *head, leaf = p.split("/")
        t = tree
        for h in head:
            t = t.setdefault(h, {})
        t[leaf] = v
    return tree


japply = jax.jit(functools.partial(jopt.apply, jopt.OptConfig(
    lr=1e-3, warmup_steps=2, total_steps=20, state_bits=8)))
wit = []
for k in range(len(W[0]["steps"]) - 1):
    shapes = {p: g.shape
              for p, g in zip(wpaths, W[0]["steps"][k]["pod_grads"][0])}
    err = {p: jnp.zeros((2, *sh), jnp.float32) for p, sh in shapes.items()}
    acc = {p: np.zeros(sh, np.float32) for p, sh in shapes.items()}
    for i in range(2):
        pods = [W[r]["steps"][k]["pod_grads"][i] for r in range(2)]
        red, err = gc.compressed_allreduce(
            {p: jnp.asarray(np.stack([pods[0][j], pods[1][j]]))
             for j, p in enumerate(wpaths)}, err, pod_mesh, "pod")
        for p in wpaths:
            r = np.asarray(red[p])
            assert np.array_equal(r[0], r[1]), p
            acc[p] = acc[p] + r[0]
    g = {p: acc[p] / np.float32(2) for p in wpaths}
    st = W[0]["steps"][k]
    params, opt, metrics = japply(jax.tree.map(jnp.asarray, st["params"]),
                                  jax.tree.map(jnp.asarray, st["opt"]),
                                  jax.tree.map(jnp.asarray, nest(g)))
    wit.append({"grads": g, "params": jax.tree.map(np.asarray, params),
                "opt": jax.tree.map(np.asarray, opt),
                "grad_norm": float(metrics["grad_norm"])})
with open(f"{out}/witness_ref.pkl", "wb") as f:
    pickle.dump(wit, f)
print("REF_OK")
'''

RANKS = r'''
import dataclasses, hashlib, json, os, pickle, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                           sys.argv[4])
from repro_torch import device as D
D.init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                   world_size=world, timeout_s=120)
import repro_torch.configs as C
from repro_torch.data import pipeline
from repro_torch.launch.mesh import make_block_mesh
from repro_torch.models import model as model_lib
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import flatten
from repro_torch.sharding import ctx as shard_ctx, plans
from repro_torch.train import grad_compression as gc
from repro_torch.train import optimizer as opt_lib, train_step as T
from torch.distributed.tensor import DTensor, Replicate, Shard

res = {}
WITNESS_STEPS = 6
z = np.load(os.path.join(out, "codec_in.npz"))
kinds = json.loads(sys.argv[5])


def whole(t):
    return t.detach().full_tensor() if isinstance(t, DTensor) else t.detach()


def cast(k, x):
    x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(torch.bfloat16) if kinds[k] == "bf16" else x


def codec(mesh, pod, shard):
    """Each leaf's pod row; sharded over data in ``shard`` parts."""
    d = mesh.get_coordinate()[1]
    g, e = {}, {}
    for k in kinds:
        x, y = z["g/" + k][pod], z["e/" + k][pod]
        if shard > 1:
            n = x.shape[0] // shard
            x, y = x[d * n:(d + 1) * n], y[d * n:(d + 1) * n]
            g[k] = DTensor.from_local(cast(k, x), mesh,
                                      [Replicate(), Shard(0), Replicate()],
                                      run_check=False)
        else:
            g[k] = cast(k, x)
        e[k] = torch.from_numpy(np.ascontiguousarray(y))
    red, new = gc.compressed_allreduce(g, e, mesh, "pod")
    return {k: [whole(red[k]).numpy().tolist(),
                (whole(DTensor.from_local(new[k], mesh, g[k].placements,
                                          run_check=False))
                 if shard > 1 else new[k]).numpy().tolist()]
            for k in kinds}


axes = plans.MeshAxes(dp=("data",), model="model")  # pod: a replica axis
DS = dataclasses.replace(C.get_smoke("deepseek_7b"), param_dtype="float32")
SHAPE = ShapeConfig("t", "train", seq_len=16, global_batch=8, microbatch=2)
OPT = opt_lib.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)


def setup(cfg, shape, bits=None):
    lay = plans.state_layouts(model_lib.abstract_params(cfg), mesh, axes,
                              state_bits=bits)
    ctx = shard_ctx.ShardCtx(mesh, ("pod", "data"), "model",
                             tp=plans.tp_layout(cfg, mesh))
    data = pipeline.DataIterator(cfg, shape, device="cpu",
                                 shardings=pipeline.batch_shards(
                                     mesh, ("pod", "data"),
                                     shape.microbatch))
    return lay, ctx, data


def digest(tree):
    return hashlib.sha256(b"".join(
        whole(t).contiguous().reshape(-1).view(torch.uint8).numpy()
        .tobytes() for _, t in flatten(tree))).hexdigest()


def run(cfg, shape, opt, n, **kw):
    lay, ctx, data = setup(cfg, shape)
    state = T.make_sharded_train_state(cfg, 0, opt, lay, device="cpu")
    step = T.make_train_step(cfg, shape, opt, **kw)
    hist, digests = [], []
    for i in range(n):
        with shard_ctx.use(ctx):
            state, m = step(state, data.batch(i))
        hist.append([float(m["loss"]), float(m["grad_norm"])])
        digests.append(digest(state["params"]))
    return {"hist": hist, "digests": digests}


def tree_np(tree):
    return {k: tree_np(v) if isinstance(v, dict)
            else whole(v).clone().numpy() for k, v in tree.items()}


def witness_int8(n_steps):
    """The overlapped step with int8 moments for ``n_steps`` steps:
    each step's state before its update, the gradient its update takes
    and this pod's gradients as each microbatch hands them to the pod
    reduce; then the last state.  The losses are returned."""
    opt8 = dataclasses.replace(OPT, state_bits=8)
    steps = []
    apply, start = opt_lib.apply, gc.start_pod_reduce

    def start_(grads, *a, **k):
        steps[-1]["pod_grads"].append([g.detach().clone().numpy()
                                       for g in grads])
        return start(grads, *a, **k)

    def capture(cfg, params, opt_state, grads):
        steps[-1].update(params=tree_np(params), opt=tree_np(opt_state),
                         grads=tree_np(grads))
        return apply(cfg, params, opt_state, grads)

    lay, ctx, data = setup(DS, SHAPE, bits=8)
    state = T.make_sharded_train_state(DS, 0, opt8, lay, device="cpu")
    step = T.make_train_step(DS, SHAPE, opt8, overlap_comm=True, mesh=mesh)
    opt_lib.apply, gc.start_pod_reduce = capture, start_
    losses = []
    try:
        for i in range(n_steps):
            steps.append({"pod_grads": []})
            with shard_ctx.use(ctx):
                state, m = step(state, data.batch(i))
            losses.append([float(m["loss"]), float(m["grad_norm"])])
    finally:
        opt_lib.apply, gc.start_pod_reduce = apply, start
    steps.append({"params": tree_np(state["params"]),
                  "opt": tree_np(state["opt"])})
    with open(os.path.join(out, f"witness_r{rank}.pkl"), "wb") as f:
        pickle.dump({"paths": [p for p, _ in flatten(state["params"])],
                     "steps": steps}, f)
    return losses


if world == 2:
    mesh = make_block_mesh(range(2), (2, 1, 1), ("pod", "data", "model"))
    res["codec"] = codec(mesh, rank, 1)
    res["witness_int8"] = witness_int8(WITNESS_STEPS)
else:
    mesh = make_block_mesh(range(4), (2, 2, 1), ("pod", "data", "model"))
    pod = mesh.get_coordinate()[0]
    res["codec_sharded"] = codec(mesh, pod, 2)
    # the port's own per-pod gradients, microbatch by microbatch, from
    # the initial state (each pod's whole leaves on its data rank 0)
    lay, ctx, data = setup(DS, SHAPE)
    state = T.make_sharded_train_state(DS, 0, OPT, lay, device="cpu")
    b = data.batch(0)
    for i in range(2):
        with shard_ctx.use(ctx.pod_local("pod")):
            _, g = T.value_and_grad(state["params"], DS,
                                    T._split_micro(b, 2, i))
        pg = {p: whole(t).numpy() for p, t in flatten(g)}
        both = [None, None]
        for p_ in range(2):
            src = {k: torch.from_numpy(v) for k, v in pg.items()}
            objs = [src]
            dist.broadcast_object_list(objs, src=2 * p_)
            both[p_] = objs[0]
        if rank == 0:
            np.savez(os.path.join(out, f"pod_grads_mb{i}.npz"),
                     **{p: np.stack([both[0][p].numpy(), both[1][p].numpy()])
                        for p in pg})
    # the overlapped step's gradient before the optimizer, and the order
    # of its backward passes, reduces and waits
    seen, events = {}, []
    apply, vg = opt_lib.apply, T.value_and_grad
    start, wait = gc.start_pod_reduce, gc.PodReduce.wait

    def capture(cfg, params, opt_state, grads):
        if not seen:
            seen.update({p: whole(t).numpy() for p, t in flatten(grads)})
        return apply(cfg, params, opt_state, grads)

    def vg_(*a, **k):
        events.append("backward")
        return vg(*a, **k)

    def start_(*a, **k):
        events.append("issue")
        return start(*a, **k)

    def wait_(self, into=None):
        events.append("wait")
        return wait(self, into)

    opt_lib.apply, T.value_and_grad = capture, vg_
    gc.start_pod_reduce, gc.PodReduce.wait = start_, wait_
    lay, ctx, data = setup(DS, SHAPE)
    state = T.make_sharded_train_state(DS, 0, OPT, lay, device="cpu")
    step = T.make_train_step(DS, SHAPE, OPT, overlap_comm=True, mesh=mesh)
    with shard_ctx.use(ctx):
        step(state, data.batch(0))
    res["events"] = list(events)
    # one microbatch still takes the compressed path
    events.clear()
    one = ShapeConfig("t", "train", seq_len=16, global_batch=8, microbatch=1)
    lay1, ctx1, data1 = setup(DS, one)
    state1 = T.make_sharded_train_state(DS, 0, OPT, lay1, device="cpu")
    with shard_ctx.use(ctx1):
        T.make_train_step(DS, one, OPT, overlap_comm=True,
                          mesh=mesh)(state1, data1.batch(0))
    res["events_one_micro"] = list(events)
    opt_lib.apply, T.value_and_grad = apply, vg
    gc.start_pod_reduce, gc.PodReduce.wait = start, wait
    res["pod_reduce"] = {k: v for k, v in step.pod_reduce.items()
                         if k in ("n_pods", "ef_bytes")}
    if rank in (0, 2):
        np.savez(os.path.join(out, f"overlap_grads_r{rank}.npz"), **seen)
    res["serial"] = run(DS, SHAPE, OPT, 3)
    res["overlap"] = run(DS, SHAPE, OPT, 3, overlap_comm=True, mesh=mesh)
    L4 = dataclasses.replace(C.get_smoke("llama4_maverick_400b"),
                             param_dtype="float32")
    L4_SHAPE = ShapeConfig("t", "train", seq_len=16, global_batch=8,
                           microbatch=2)
    res["moe"] = run(L4, L4_SHAPE, opt_lib.OptConfig(warmup_steps=1,
                                                     total_steps=4), 2,
                     overlap_comm=True, mesh=mesh)
print("RESULT " + json.dumps(res))
dist.destroy_process_group()
'''


def _spawn(world, tmp):
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    kinds = json.dumps({k: v[1] for k, v in CODEC_IN.items()})
    store = tmp / f"store_{world}"
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(store),
         str(tmp), kinds], env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]


def _collect(procs, timeout=240):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            p.kill()
    res = []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed:\n{so}\n{se[-4000:]}"
        line = [x for x in so.splitlines() if x.startswith("RESULT ")]
        res.append(json.loads(line[-1][len("RESULT "):]))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's worlds of 2 and 4 ranks, then the reference's
    subprocess on their inputs; {2, 4: each rank's JSON, "ref": the
    reference's npz, "dir"}."""
    tmp = tmp_path_factory.mktemp("gc")
    g, e = _codec_inputs()
    np.savez(tmp / "codec_in.npz", **{f"g/{k}": v for k, v in g.items()},
             **{f"e/{k}": v for k, v in e.items()})
    two, four = _spawn(2, tmp), _spawn(4, tmp)
    out = {2: _collect(two), 4: _collect(four), "dir": tmp}
    kinds = json.dumps({k: v[1] for k, v in CODEC_IN.items()})
    r = subprocess.run([sys.executable, "-c", REF, str(tmp), kinds], env=dict(
        ENV, XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0 and "REF_OK" in r.stdout, r.stderr[-4000:]
    out["ref"] = np.load(tmp / "ref_out.npz")
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_allreduce_matches_the_reference_on_xla(runs, world):
    """Each pod's mean and error feedback, bit for bit the reference's on
    its (2, 2, 2) mesh; at world 4 each pod's leaves are DTensors sharded
    over ``data``, so the scale is taken over the whole leaf."""
    key = "codec" if world == 2 else "codec_sharded"
    ref = runs["ref"]
    for r, res in enumerate(runs[world]):
        pod = r if world == 2 else r // 2
        for k in CODEC_IN:
            red, err = (np.asarray(x, np.float32)
                        for x in res[key][k])
            np.testing.assert_array_equal(_bits(red),
                                          _bits(ref[f"red/{k}"][pod]))
            np.testing.assert_array_equal(_bits(err),
                                          _bits(ref[f"err/{k}"][pod]))


def test_overlapped_gradient_is_the_references_reducer_per_microbatch(runs):
    ref = runs["ref"]
    for r in (0, 2):
        got = np.load(runs["dir"] / f"overlap_grads_r{r}.npz")
        assert got.files
        for p in got.files:
            np.testing.assert_array_equal(_bits(got[p]),
                                          _bits(ref[f"step/{p}"]), err_msg=p)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_overlapped_int8_steps_are_the_references_reducer_and_update(runs):
    """6 steps of the overlapped step with int8 moments on 2 pods, each
    held against the reference from the port's state before it: its
    gradient the reference's ``compressed_allreduce`` of the port's
    per-pod microbatch gradients with the error carried, bit for bit;
    its update the reference's jitted int8 AdamW: params within rtol
    1e-5, the moments' codes within 1 on at most 1% of a leaf's elements
    and their scales within rtol 1e-5 (``test_optimizer_apply_vs_jax``'s
    bounds in ``tests/test_torch_train.py``), the grad norm within rtol
    1e-6.  Both pods' records are the same bit for bit."""
    W = []
    for r in range(2):
        with open(runs["dir"] / f"witness_r{r}.pkl", "rb") as f:
            W.append(pickle.load(f))
    with open(runs["dir"] / "witness_ref.pkl", "rb") as f:
        ref = pickle.load(f)
    steps = W[0]["steps"]
    assert len(ref) == len(steps) - 1 == 6
    for a, b in zip(steps, W[1]["steps"]):
        for key in ("params", "opt", "grads"):
            if key in a:
                fa, fb = _flat(a[key]), _flat(b[key])
                assert fa.keys() == fb.keys()
                for p in fa:
                    np.testing.assert_array_equal(_bits(fa[p]), _bits(fb[p]))
    losses = runs[2][0]["witness_int8"]
    assert np.isfinite(losses).all()
    for k, want in enumerate(ref):
        got = _flat(steps[k]["grads"])
        assert got.keys() == want["grads"].keys()
        for p, g in want["grads"].items():
            np.testing.assert_array_equal(_bits(got[p]), _bits(g),
                                          err_msg=f"step {k} {p}")
        np.testing.assert_allclose(losses[k][1], want["grad_norm"],
                                   rtol=1e-6)
        nxt, w = _flat(steps[k + 1]["params"]), _flat(want["params"])
        assert nxt.keys() == w.keys()
        for p in w:
            np.testing.assert_allclose(nxt[p], w[p], rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {k} {p}")
        nxt, w = _flat(steps[k + 1]["opt"]), _flat(want["opt"])
        assert nxt.keys() == w.keys()
        for p in w:
            if p.endswith("/q"):
                dq = np.abs(nxt[p].astype(int) - w[p].astype(int))
                assert dq.max() <= 1 and dq.mean() <= 0.01, (k, p)
            elif p == "step":
                assert int(nxt[p]) == int(w[p]) == k + 1
            else:
                np.testing.assert_allclose(nxt[p], w[p], rtol=1e-5,
                                           err_msg=f"step {k} {p}")


def test_the_pod_reduce_runs_under_the_next_microbatch(runs):
    """Microbatch 0's reduce is issued after its backward and waited on
    after microbatch 1's backward; one microbatch is compressed too."""
    for res in runs[4]:
        assert res["events"] == ["backward", "issue", "backward", "wait",
                                 "issue", "wait"]
        assert res["events_one_micro"] == ["backward", "issue", "wait"]
        assert res["pod_reduce"]["n_pods"] == 2
        assert res["pod_reduce"]["ef_bytes"] > 0


def test_overlapped_pods_stay_bitwise_in_sync(runs):
    res = runs[4]
    for run in ("overlap", "moe"):
        for step in range(len(res[0][run]["digests"])):
            assert len({r[run]["digests"][step] for r in res}) == 1, \
                (run, step)
        assert len({json.dumps(r[run]["hist"]) for r in res}) == 1


def test_overlapped_losses_track_the_serial_path(runs):
    res = runs[4][0]
    over = np.asarray(res["overlap"]["hist"])[:, 0]
    base = np.asarray(res["serial"]["hist"])[:, 0]
    np.testing.assert_allclose(over, base, rtol=0.05, atol=0.05)
    assert over[0] == pytest.approx(base[0], rel=1e-6)
    # the compression moves the gradient: the trajectories are not one
    assert res["overlap"]["digests"][-1] != res["serial"]["digests"][-1]


def test_overlapped_moe_runs_finite(runs):
    hist = np.asarray(runs[4][0]["moe"]["hist"])
    assert hist.shape == (2, 2) and np.isfinite(hist).all()


def test_shard_ctx_refuses_an_axis_it_does_not_place():
    """Every mesh axis is summed, pod-local or the model axis: a batch
    split over an axis nobody names would leave the pods apart."""
    mesh = {"pod": 2, "data": 2, "model": 1}
    with pytest.raises(ValueError, match="pod"):
        shard_ctx.ShardCtx(mesh, ("data",), "model")
    ctx = shard_ctx.ShardCtx(mesh, ("pod", "data"), "model")
    local = ctx.pod_local("pod")
    assert local.dp == ("data",) and local.local == ("pod",)
    assert local.pod_local("pod") is local
    assert shard_ctx._dp_size(local) == 2 and shard_ctx._dp_size(ctx) == 4
