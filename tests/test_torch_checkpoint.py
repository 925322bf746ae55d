"""The port's checkpoints and preemption surface against the JAX package,
on the CPU at smoke size, fp32 unless stated.

* ``CheckpointManager``: the cases of tests/test_checkpoint.py (keep-N
  rotation, the latest step, ``save_async`` + ``wait`` bit for bit,
  back-to-back async saves, a shape mismatch, a leftover ``.tmp``), a
  corrupted leaf, an in-place update after ``save_async`` and ``meta``
  targets;
* across the packages: a checkpoint written by either restores in the
  other leaf for leaf and bit for bit, and both write the same files;
* a train ``BlockRuntime``'s checkpoint crossing both ways (deepseek_7b
  and zamba2_2p7b smoke configs, fp32 and int8 moments): the restored
  state is the saved one bit for bit and the next 2 steps agree at
  ``test_train_runtime_matches_jax``'s tolerance (losses, grad norms and
  learning rates at ``rtol=1e-4``);
* a paged block saved mid-flight (running, queued and evicted sessions)
  crossing both ways: the remaining emissions are equal;
* the hybrid's fp32 decode cache across the packages: the Mamba2 conv
  tail is bf16 in the reference's restore target, fp32 in the port's,
  and a restore casts to the target's dtype;
* the port's own round trips: ``suspend`` then ``resume`` is bitwise and
  continues as an uninterrupted run (train, dense serve, paged serve),
  ``progress_lost``, ``rebuild``, the three ``abstract_*`` restore
  targets, and ``launch.train --ckpt-dir/--resume``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.core.block import BlockGrant as JGrant  # noqa: E402
from repro.core.runtime import BlockRuntime as JRuntime  # noqa: E402
from repro.core.runtime import JobSpec as JJob  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.core.block import BlockGrant  # noqa: E402
from repro_torch.core.runtime import BlockRuntime, JobSpec  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.serve import serve_step  # noqa: E402
from repro_torch.serve.decode_scheduler import DecodeScheduler  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

ARCHS = ("deepseek_7b", "zamba2_2p7b")
PAGED = dict(page_size=4, n_pages=6, max_slots=2, max_seq_len=32)


def grant():
    return BlockGrant.new([(0, 0, 0)], (1, 1), 60.0)


def jgrant():
    return JGrant.new([(0, 0, 0)], (1, 1), 60.0)


def leaf_bits(tree):
    """[(dtype, shape, bytes)] of every leaf in ``jax.tree`` order: dict
    keys sorted, a Python scalar as a 0-d array."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_bits(tree[k])]
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        return [(str(t.dtype).removeprefix("torch."), tuple(t.shape),
                 t.reshape(-1).view(torch.uint8).numpy().tobytes())]
    a = np.asarray(tree)
    return [(str(a.dtype), a.shape, a.tobytes())]


def smoke_cfg(arch):
    return (jconfigs.get_smoke(arch).replace(param_dtype="float32"),
            configs.get_smoke(arch).replace(param_dtype="float32"))


# ============================================================ the manager

def tree_at(step):
    """Distinct per-step content so 'which step restored' is observable."""
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) * step,
            "b": {"bf16": torch.full((5,), 1.5 * step, dtype=torch.bfloat16),
                  "i": torch.tensor(step, dtype=torch.int32)},
            "count": step}


def _rotation(mgr):
    mgr.keep = 2
    for s in (1, 2, 3, 4, 5):
        mgr.save(s, tree_at(s))
    assert mgr.steps() == [4, 5]            # oldest steps deleted
    for s in (1, 2, 3):
        assert not os.path.exists(os.path.join(mgr.dir, f"step_{s:08d}"))
    restored, at = mgr.restore(tree_at(0), step=4)
    assert at == 4 and restored["count"] == 4


def _latest(mgr):
    mgr.keep = 5
    for s in (3, 7, 11):
        mgr.save(s, tree_at(s))
    restored, at = mgr.restore(tree_at(0), step=None)
    assert at == 11 and leaf_bits(restored) == leaf_bits(tree_at(11))
    restored7, at7 = mgr.restore(tree_at(0), step=7)
    assert at7 == 7 and restored7["count"] == 7


def _async_roundtrip(mgr):
    mgr.save_async(9, tree_at(9))
    mgr.wait()
    restored, at = mgr.restore(tree_at(0))
    assert at == 9 and leaf_bits(restored) == leaf_bits(tree_at(9))
    assert restored["b"]["bf16"].dtype == torch.bfloat16


def _async_back_to_back(mgr):
    mgr.keep = 5
    for s in (1, 2, 3):
        mgr.save_async(s, tree_at(s))
    mgr.wait()
    assert mgr.steps() == [1, 2, 3]
    restored, at = mgr.restore(tree_at(0))
    assert at == 3 and restored["count"] == 3


def _async_copies_before_return(mgr):
    """The optimizer updates its tensors in place: what save_async saves
    is the tree as it was when the call returned."""
    tree = tree_at(4)
    mgr.save_async(4, tree)
    tree["w"].add_(1.0)
    tree["b"]["bf16"].zero_()
    mgr.wait()
    restored, _ = mgr.restore(tree_at(0))
    assert leaf_bits(restored) == leaf_bits(tree_at(4))


def _shape_mismatch(mgr):
    mgr.save(1, {"w": torch.zeros(3, 4)})
    with pytest.raises(ValueError, match="cross-geometry"):
        mgr.restore({"w": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="1 leaves, expected 2"):
        mgr.restore({"w": torch.zeros(3, 4), "x": torch.zeros(1)})


def _leftover_tmp(mgr):
    mgr.save(1, tree_at(1))
    os.makedirs(os.path.join(mgr.dir, "step_00000002.tmp"))
    assert mgr.steps() == [1]
    assert mgr.restore(tree_at(0))[1] == 1
    mgr.save(2, tree_at(2))
    assert mgr.steps() == [1, 2]


def _corrupt_leaf(mgr):
    path = mgr.save(1, tree_at(1))
    with open(os.path.join(path, "manifest.json")) as f:
        leaf = json.load(f)["leaves"][0]["file"]
    with open(os.path.join(path, leaf), "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last[0] ^ 1]))
    with pytest.raises(IOError, match="crc mismatch"):
        mgr.restore(tree_at(0))
    restored, _ = mgr.restore(tree_at(0), verify=False)
    assert restored["b"]["bf16"].float().sum() != 7.5


def _meta_targets(mgr):
    mgr.save(5, tree_at(5))
    like = {"w": torch.empty(3, 4, device="meta"),
            "b": {"bf16": torch.empty(5, dtype=torch.bfloat16,
                                      device="meta"),
                  "i": torch.empty((), dtype=torch.int32, device="meta")},
            "count": 0}
    with pytest.raises(ValueError, match="meta"):
        mgr.restore(like)
    restored, _ = mgr.restore(like, device="cpu")
    assert restored["w"].device.type == "cpu"
    assert leaf_bits(restored) == leaf_bits(tree_at(5))


MANAGER_CASES = {f.__name__[1:]: f for f in (
    _rotation, _latest, _async_roundtrip, _async_back_to_back,
    _async_copies_before_return, _shape_mismatch, _leftover_tmp,
    _corrupt_leaf, _meta_targets)}


@pytest.mark.parametrize("case", sorted(MANAGER_CASES))
def test_manager(case, tmp_path):
    MANAGER_CASES[case](CheckpointManager(str(tmp_path), namespace=case,
                                          keep=3))


# ===================================================== across the packages

def mixed_trees():
    """The same tree in both packages: bf16, fp32, int8 and int32 leaves,
    a 0-d leaf, a Python int and an empty subtree."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    bf = rng.standard_normal((2, 3, 4)).astype(np.float32)
    i8 = rng.integers(-128, 128, (7,)).astype(np.int8)
    i32 = rng.integers(-2 ** 31, 2 ** 31, (2, 2)).astype(np.int32)
    jtree = {"bf16": jnp.asarray(bf, jnp.bfloat16), "f32": jnp.asarray(f32),
             "q": {"i8": jnp.asarray(i8), "i32": jnp.asarray(i32)},
             "zero_d": jnp.float32(2.5), "count": 12345, "none": None}
    ttree = {"bf16": torch.from_numpy(bf).to(torch.bfloat16),
             "f32": torch.from_numpy(f32),
             "q": {"i8": torch.from_numpy(i8), "i32": torch.from_numpy(i32)},
             "zero_d": torch.tensor(2.5), "count": 12345, "none": None}
    return jtree, ttree


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mixed_tree_crosses_packages_bit_for_bit(writer, tmp_path):
    """Saved by one package, restored by the other: every leaf's bytes,
    dtype and shape equal.  Both packages write the same manifest and the
    same leaf files."""
    jtree, ttree = mixed_trees()
    JManager(str(tmp_path), "ref").save(3, jtree)
    CheckpointManager(str(tmp_path), "port").save(3, ttree)
    ref_dir, port_dir = (str(tmp_path / ns / "step_00000003")
                         for ns in ("ref", "port"))
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir))
    for name in os.listdir(ref_dir):
        with open(os.path.join(ref_dir, name), "rb") as a, \
                open(os.path.join(port_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    want = leaf_bits(ttree)
    assert [(d, tuple(s)) for d, s, _ in leaf_bits(
        jax.tree.map(np.asarray, jtree))] == [(d, s) for d, s, _ in want]
    ns = "ref" if writer == "reference" else "port"
    if writer == "reference":
        got, at = CheckpointManager(str(tmp_path), ns).restore(ttree)
    else:
        got, at = JManager(str(tmp_path), ns).restore(jtree)
        assert got["bf16"].dtype == jnp.bfloat16
        got = jax.tree.map(np.asarray, got)
    assert at == 3 and got["count"] == 12345 and got["none"] is None
    assert leaf_bits(got) == want


# ------------------------------------------------------- train blocks

def train_jobs(arch, bits, ns):
    jcfg, cfg = smoke_cfg(arch)
    # test_train_runtime_matches_jax's optimizer; the hybrid at the lr of
    # tests/test_torch_hybrid_train.py
    kw = dict(lr=1e-2 if arch == "deepseek_7b" else 3e-3, warmup_steps=1,
              total_steps=10, eps=1e-3, state_bits=bits)
    shape = dict(seq_len=16, global_batch=2)
    jjob = JJob(jcfg, JShape("t", "train", **shape), kind="train",
                opt=jopt.OptConfig(**kw), seed=2, ckpt_namespace=ns)
    job = JobSpec(cfg, ShapeConfig("t", "train", **shape), kind="train",
                  opt=opt.OptConfig(**kw), seed=2, ckpt_namespace=ns)
    return jjob, job


def jax_state_bits(jrt):
    return leaf_bits(jax.tree.map(np.asarray, jrt.state))


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_checkpoint_crosses_packages(arch, bits, writer, tmp_path):
    """One package's train block saves after 2 steps, the other's restores
    it (bit for bit), and both take 2 more steps with the same losses,
    grad norms and learning rates."""
    jjob, job = train_jobs(arch, bits, "blk")
    root = str(tmp_path)
    if writer == "reference":
        jrt = JRuntime(jgrant(), jjob, [jax.devices()[0]], root)
        jrt.init_state()
        jrt.step(), jrt.step()
        jrt.save(async_=False)
        rt = BlockRuntime(grant(), job, devices=["cpu"], ckpt_root=root)
        assert rt.restore() == 2
    else:
        rt = BlockRuntime(grant(), job, devices=["cpu"], ckpt_root=root)
        rt.init_state()
        rt.step(), rt.step()
        rt.save(async_=False)
        jrt = JRuntime(jgrant(), jjob, [jax.devices()[0]], root)
        assert jrt.restore() == 2
    assert rt.step_count == jrt.step_count == 2
    assert leaf_bits(rt.state) == jax_state_bits(jrt)
    for _ in range(2):
        want, got = jrt.step(), rt.step()
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


# ------------------------------------------------------- paged blocks

def paged_jobs(ns):
    jcfg, cfg = smoke_cfg("deepseek_7b")
    shape = dict(seq_len=32, global_batch=1)
    return (JJob(jcfg, JShape("s", "serve", **shape), kind="serve",
                 paged=True, ckpt_namespace=ns, **PAGED),
            JobSpec(cfg, ShapeConfig("s", "serve", **shape), kind="serve",
                    paged=True, ckpt_namespace=ns, **PAGED))


def start_sessions(rt):
    return [rt.start_session([s, s + 1, s + 2], max_new_tokens=10)
            for s in (1, 5, 9)]


def feed_to_end(rt):
    out = []
    while not rt.idle_serve:
        out.extend(rt.feed())
    return out


def feed_until_evicted(rt):
    """Feed until a session has been evicted; the scheduler then has a
    running, a queued and an evicted session."""
    out = []
    for _ in range(100):
        if any(e["event"] == "evicted" for e in out):
            break
        out.extend(rt.feed())
    sch = rt.sessions
    states = {s.state for s in sch.sessions.values()}
    assert {"running", "queued"} <= states and sch.evictions >= 1
    return out


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_paged_checkpoint_mid_flight_crosses_packages(writer, tmp_path):
    """A paged block saved mid-flight (sessions running, queued and
    evicted) restores in the other package's block, and the remaining
    emissions are the writer's, event for event."""
    jjob, job = paged_jobs("pg")
    root = str(tmp_path)
    if writer == "reference":
        src = JRuntime(jgrant(), jjob, [jax.devices()[0]], root)
    else:
        src = BlockRuntime(grant(), job, devices=["cpu"], ckpt_root=root)
    src.init_state()
    sids = start_sessions(src)
    feed_until_evicted(src)
    src.save(async_=False)
    if writer == "reference":
        dst = BlockRuntime(grant(), job, devices=["cpu"], ckpt_root=root)
    else:
        dst = JRuntime(jgrant(), jjob, [jax.devices()[0]], root)
    assert dst.restore() == src.step_count
    assert leaf_bits(dst.state["params"]) == leaf_bits(
        jax.tree.map(np.asarray, src.state["params"]))
    want, got = feed_to_end(src), feed_to_end(dst)
    assert got == want
    for sid in sids:
        assert dst.sessions.sessions[sid].generated == \
            src.sessions.sessions[sid].generated


# ------------------------------------------- the hybrid's fp32 conv tail

def test_hybrid_fp32_cache_across_packages(tmp_path):
    """The decision for an fp32 hybrid's decode cache: a restore casts
    each leaf to its target's dtype, as the reference's does.  The port's
    target keeps the Mamba2 conv tail in the model's dtype (fp32); the
    reference's keeps it in bf16 whatever the model's.  So the port's
    tail, restored by the reference, is rounded to bf16 (as the reference
    rounds its own fp32 prefill tail on restore), and the reference's,
    restored by the port, comes back exactly; every other leaf crosses bit
    for bit both ways."""
    jcfg, cfg = smoke_cfg("zamba2_2p7b")
    shape = dict(seq_len=16, global_batch=2)
    jjob = JJob(jcfg, JShape("s", "serve", **shape), kind="serve",
                ckpt_namespace="hy")
    job = JobSpec(cfg, ShapeConfig("s", "serve", **shape), kind="serve",
                  ckpt_namespace="hy")
    tokens = pipeline.synthetic_batch(cfg, ShapeConfig("p", "prefill", 8, 2),
                                      step=0, seed=3)["tokens"]
    rt = BlockRuntime(grant(), job, devices=["cpu"],
                      ckpt_root=str(tmp_path / "port"))
    rt.init_state()
    rt.prefill({"tokens": tokens})
    rt.save(async_=False)
    assert rt.cache["mamba"]["conv"].dtype == torch.float32
    jrt = JRuntime(jgrant(), jjob, [jax.devices()[0]],
                   str(tmp_path / "port"))
    jrt.restore()
    jconv = np.asarray(jrt.cache["mamba"]["conv"])
    assert jconv.dtype.name == "bfloat16"
    assert leaf_bits(torch.from_numpy(jconv.astype(np.float32))) == \
        leaf_bits(rt.cache["mamba"]["conv"].to(torch.bfloat16).float())
    assert leaf_bits(rt.cache["mamba"]["ssm"]) == leaf_bits(
        np.asarray(jrt.cache["mamba"]["ssm"]))
    assert leaf_bits(rt.cache["attn"]) == leaf_bits(
        jax.tree.map(np.asarray, jrt.cache["attn"]))
    assert int(jrt.cache_len) == rt.cache_len == 8

    # the other way: the reference's own prefill context into the port
    jrt2 = JRuntime(jgrant(), jjob, [jax.devices()[0]],
                    str(tmp_path / "ref"))
    jrt2.init_state()
    jrt2.prefill({"tokens": jnp.asarray(tokens)})
    jrt2.save(async_=False)
    rt2 = BlockRuntime(grant(), job, devices=["cpu"],
                       ckpt_root=str(tmp_path / "ref"))
    rt2.restore()
    src = np.asarray(jrt2.cache["mamba"]["conv"]).astype(np.float32)
    assert rt2.cache["mamba"]["conv"].dtype == torch.float32
    assert leaf_bits(rt2.cache["mamba"]["conv"]) == leaf_bits(src)
    assert leaf_bits(rt2.token) == leaf_bits(np.asarray(jrt2.token))
    assert rt2.cache_len == 8


# ================================================== the port's round trips

def no_random_init(monkeypatch):
    """Make any random init (params drawn on a real device) fail."""
    init = transformer.init_params

    def guarded(cfg, *, seed=0, device="cuda"):
        assert torch.device(device).type == "meta", "random init on resume"
        return init(cfg, seed=seed, device=device)

    monkeypatch.setattr(transformer, "init_params", guarded)


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_suspend_resume_is_bitwise_and_continues(arch, bits, tmp_path,
                                                       monkeypatch):
    """A step and a dispatched one, ``suspend`` (which drains it), then
    ``resume`` on the CPU: the state is the suspended one bit for bit,
    with no random init, and the losses of all 4 steps are an
    uninterrupted block's."""
    _, job = train_jobs(arch, bits, "t")
    whole = BlockRuntime(grant(), job, devices=["cpu"])
    whole.init_state()
    want = [whole.step()["loss"] for _ in range(4)]

    rt = BlockRuntime(grant(), job, devices=["cpu"],
                      ckpt_root=str(tmp_path))
    rt.init_state()
    got = [rt.step()["loss"]]
    rt.dispatch()
    live = leaf_bits(rt.state)
    assert rt.suspend() == {"step": 2, "drained_steps": 1}
    assert rt.suspended and rt.state is None and rt.data is None
    saved, _ = CheckpointManager(str(tmp_path), "t").restore(
        {"state": train_step.abstract_train_state(job.cfg, job.opt),
         "step_count": 0}, device="cpu")
    assert saved["step_count"] == 2 and leaf_bits(saved["state"]) == live
    no_random_init(monkeypatch)
    assert rt.resume(grant(), ["cpu"]) == 2 and not rt.suspended
    assert leaf_bits(rt.state) == live
    assert all(p.requires_grad for _, p in
               transformer.flatten(rt.state["params"]))
    got += [rt.step()["loss"] for _ in range(2)]
    assert got == [want[0], want[2], want[3]]   # step 1 was drained
    with pytest.raises(ValueError, match="after suspend"):
        rt.resume(grant(), ["cpu"])


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_serve_suspend_resume_is_bitwise_and_continues(arch, tmp_path,
                                                             monkeypatch):
    """Prefill and 3 decode steps, suspend, resume: the cache (the
    hybrid's Mamba2 conv and SSM states among it), the token and
    ``cache_len`` are the suspended ones bit for bit, and the 3 steps after
    give an uninterrupted block's tokens."""
    _, cfg = smoke_cfg(arch)
    job = JobSpec(cfg, ShapeConfig("s", "serve", seq_len=16, global_batch=2),
                  kind="serve", ckpt_namespace="d")
    tokens = pipeline.synthetic_batch(cfg, ShapeConfig("p", "prefill", 8, 2),
                                      step=0, seed=3)["tokens"]

    def block(root=None):
        rt = BlockRuntime(grant(), job, devices=["cpu"], ckpt_root=root)
        rt.init_state()
        rt.prefill({"tokens": tokens})
        return rt

    whole = block()
    want = []
    for _ in range(6):
        whole.step()
        want.append(whole.token.clone())
    rt = block(str(tmp_path))
    got = []
    for _ in range(3):
        rt.step()
        got.append(rt.token.clone())
    ctx = leaf_bits(rt._decode_ctx()) + leaf_bits(rt.state)
    rt.suspend()
    assert rt.cache is None and rt.model is None and rt.token is None
    no_random_init(monkeypatch)
    assert rt.resume(grant(), ["cpu"]) == 3
    assert leaf_bits(rt._decode_ctx()) + leaf_bits(rt.state) == ctx
    assert rt.cache_len == 8 + 3
    for _ in range(3):
        rt.step()
        got.append(rt.token.clone())
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_paged_serve_suspend_resume_continues(tmp_path, monkeypatch):
    """A paged block suspended mid-flight (running, queued and evicted
    sessions) resumes with its pool, page table and sessions as they
    were, and the rest of its emissions are an uninterrupted block's."""
    _, job = paged_jobs("p")

    def block(root=None):
        rt = BlockRuntime(grant(), job, devices=["cpu"], ckpt_root=root)
        rt.init_state()
        return rt, start_sessions(rt)

    whole, sids = block()
    want = feed_to_end(whole)
    rt, _ = block(str(tmp_path))
    got = feed_until_evicted(rt)
    tree = rt.sessions.state_tree()
    pool, table = leaf_bits(tree["pool"]), rt.sessions.page_table.copy()
    rt.suspend()
    assert rt.sessions is None
    no_random_init(monkeypatch)
    rt.resume(grant(), ["cpu"])
    assert leaf_bits(rt.sessions.pool) == pool
    assert np.array_equal(rt.sessions.page_table, table)
    got += feed_to_end(rt)
    assert got == want
    for sid in sids:
        assert rt.sessions.sessions[sid].generated == \
            whole.sessions.sessions[sid].generated


def test_progress_lost_counts_steps_past_the_last_save(tmp_path):
    _, job = train_jobs("deepseek_7b", None, "pl")
    rt = BlockRuntime(grant(), job, devices=["cpu"], ckpt_root=str(tmp_path))
    rt.init_state()
    assert rt.progress_lost == 0
    rt.step(), rt.step()
    assert rt.progress_lost == 2
    rt.save()
    assert rt.progress_lost == 0 and rt.last_saved_step == 2
    rt.step()
    rt.dispatch()
    assert rt.progress_lost == 2
    rt.drain()
    assert rt.restore() == 2 and rt.progress_lost == 0
    assert rt.step_count == 2


def test_rebuild_adopts_the_old_blocks_namespace(tmp_path):
    """``rebuild`` on new devices restores the old block's latest
    checkpoint through its manager (same namespace and history); a block
    with no checkpoint is rebuilt from a fresh init."""
    _, job = train_jobs("deepseek_7b", None, None)
    old = BlockRuntime(grant(), job, devices=["cpu"],
                       ckpt_root=str(tmp_path / "a"))
    old.init_state()
    old.step(), old.step()
    old.save()                             # async: rebuild waits for it
    state = leaf_bits(old.state)
    new = BlockRuntime.rebuild(old, grant(), ["cpu"], str(tmp_path / "b"))
    assert new.ckpt is old.ckpt and new.ckpt.namespace == old.grant.block_id
    assert new.step_count == 2 and leaf_bits(new.state) == state
    assert new.step()["loss"] == old.step()["loss"]

    bare = BlockRuntime(grant(), job, devices=["cpu"],
                        ckpt_root=str(tmp_path / "c"))
    fresh = BlockRuntime.rebuild(bare, grant(), ["cpu"], str(tmp_path / "d"))
    assert fresh.step_count == 0 and fresh.ckpt is not bare.ckpt
    assert fresh.ckpt.dir == str(tmp_path / "d" / fresh.grant.block_id)


def _kinds(tree):
    """[(dtype, shape)] of every leaf, data untouched."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _kinds(tree[k])]
    return [(str(tree.dtype).removeprefix("torch."), tuple(tree.shape))]


def _all_meta(tree):
    return all(t.device.type == "meta" for t in jax.tree.leaves(tree))


@pytest.mark.parametrize("case", ["cache_dense", "cache_hybrid",
                                  "train_f32", "train_int8", "paged"])
def test_abstract_targets_match_the_real_trees(case):
    """Each restore target is its real tree's structure, shapes and
    dtypes, on ``meta``."""
    arch = "zamba2_2p7b" if case == "cache_hybrid" else "deepseek_7b"
    cfg = configs.get_smoke(arch)
    if case.startswith("cache"):
        got = serve_step.abstract_cache(cfg, 2, 16)
        want = model.init_cache(cfg, 2, 16, "cpu")
    elif case.startswith("train"):
        o = opt.OptConfig(state_bits=8 if case == "train_int8" else None)
        got = train_step.abstract_train_state(cfg, o)
        want = train_step.make_train_state(cfg, 0, o, device="cpu")
    else:
        got = DecodeScheduler.abstract_state(cfg, **PAGED)
        want = DecodeScheduler(cfg, model.init_params(cfg, device="cpu"),
                               device="cpu", **PAGED).state_tree()
    assert _all_meta(got) and _kinds(got) == _kinds(want)
    flat = transformer.flatten(got)
    assert [p for p, _ in flat] == [p for p, _ in transformer.flatten(want)]


class Preempted(Exception):
    pass


def test_launcher_resume_equals_an_uninterrupted_run(tmp_path, capsys,
                                                     monkeypatch):
    """``launch.train --ckpt-dir``: 4 steps straight give the losses of a
    run preempted after its step-2 checkpoint and a ``--resume``d run of
    the other 2; both save every 2 steps, and the preempted run's async
    save lands though its loop raised."""
    argv = ["--arch", "deepseek_7b", "--smoke", "--device", "cpu", "--steps",
            "4", "--seq-len", "16", "--global-batch", "2", "--log-every", "1",
            "--ckpt-every", "2"]

    def args(d, *extra):
        return launch_train.parse_args(argv + ["--ckpt-dir", str(d), *extra])

    whole = launch_train.run(args(tmp_path / "whole"))
    step, first = BlockRuntime.step_async, []

    def preempted_after_two(self):
        if self.step_count == 2:
            raise Preempted
        metrics = step(self)
        first.append(float(metrics["loss"]))
        return metrics

    # the launcher's steps are the daemon's dispatches
    monkeypatch.setattr(BlockRuntime, "step_async", preempted_after_two)
    with pytest.raises(Preempted):
        launch_train.run(args(tmp_path / "cut"))
    monkeypatch.undo()
    second = launch_train.run(args(tmp_path / "cut", "--resume"))
    assert second["start_step"] == 2
    assert whole["checkpoints"] == second["checkpoints"] == [2, 4]
    assert first + [h["loss"] for h in second["history"]] == \
        [h["loss"] for h in whole["history"]]
    assert os.listdir(tmp_path / "cut") == [whole["cfg"].name]
    capsys.readouterr()
    assert launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "cut"),
                                     "--resume", "--steps", "6"]) == 0
    out = capsys.readouterr().out
    assert "# resumed from step 4" in out
    assert "checkpoints=[2, 4, 6]" in out


@pytest.mark.parametrize("kind", ["train", "dense", "paged"])
def test_suspend_frees_the_state_without_garbage_collection(kind, tmp_path):
    """``suspend()`` leaves no reference to the block's tensors, not even
    one in a reference cycle that only the garbage collector would break:
    on a card that memory would stay allocated, and the chips would not be
    free for another block."""
    import gc
    import weakref
    if kind == "train":
        _, job = train_jobs("zamba2_2p7b", None, "k")
    elif kind == "paged":
        _, job = paged_jobs("k")
    else:
        job = JobSpec(smoke_cfg("zamba2_2p7b")[1],
                      ShapeConfig("s", "serve", 16, 2), kind="serve",
                      ckpt_namespace="k")
    rt = BlockRuntime(grant(), job, devices=["cpu"], ckpt_root=str(tmp_path))
    rt.init_state()
    if kind == "paged":
        start_sessions(rt)
        rt.feed(2)
    else:
        rt.step()
    rt.save()                                # an async save still landing
    tensors = [weakref.ref(t) for t in jax.tree.leaves(rt._payload())
               if isinstance(t, torch.Tensor)]
    gc.disable()
    try:
        rt.suspend()
        alive = sum(r() is not None for r in tensors)
    finally:
        gc.enable()
    assert alive == 0 and len(tensors) > 10
