"""The port's control plane against the JAX package's, on the CPU.

* **Twins** of the reference's daemon, engine and preemption tests: each
  runs the reference test's own code (``tests/test_daemon.py``,
  ``test_engine.py``, ``test_preemption.py``) with every name it takes
  from ``repro`` bound to the port's object of the same name, and the
  devices the port's (``"cpu"`` per chip).  The preemption tests that
  build real blocks (an xLSTM, which the port lacks) are written out
  below with deepseek_7b's smoke config.
* **Parity**: one deterministic script, on the model clock, run on both
  daemons with ``SimJobSpec`` blocks gives the same event stream.
* **A real block through both daemons**: deepseek_7b's smoke config
  trained across a preemption and a tick-driven resume.
* The launchers through the daemon, the analytic roofline on H100 peaks
  and the Monitor's MFU, and the control phase of ``chip_smoke.py`` at
  smoke size with the port's race detector installed.

Tolerances: train losses across the packages at ``rtol=1e-4``, as the
train slice holds them (``tests/test_torch_train.py``: fp32 params, the
two packages sum their matmuls in different orders); everything within
the port, bit for bit.
"""
import dataclasses
import importlib
import inspect
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_daemon as ref_daemon  # noqa: E402
import test_engine as ref_engine  # noqa: E402
import test_preemption as ref_preemption  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
from repro.core.daemon import ClusterDaemon as JDaemon  # noqa: E402
from repro.core.runtime import JobSpec as JJob  # noqa: E402
from repro.core.runtime import SimJobSpec as JSim  # noqa: E402
from repro.core.topology import Topology as JTopology  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.train.optimizer import OptConfig as JOpt  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.block import BlockState  # noqa: E402
from repro_torch.core.controller import ClusterController  # noqa: E402
from repro_torch.core.daemon import ClusterDaemon  # noqa: E402
from repro_torch.core.runtime import JobSpec, SimJobSpec  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.train import compile_cache  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

ROOT = Path(__file__).resolve().parents[1]


# ================================================================ twins

def make_daemon(tmp_path, pod_x=4, pod_y=2, **kw):
    topo = Topology(n_pods=1, pod_x=pod_x, pod_y=pod_y)
    return ClusterDaemon(topo, devices=["cpu"] * topo.n_chips,
                         ckpt_root=str(tmp_path / "ckpt"), **kw)


def make_ctl(tmp_path, pod_x=4, pod_y=2, n_pods=1):
    topo = Topology(n_pods=n_pods, pod_x=pod_x, pod_y=pod_y)
    return ClusterController(topo, devices=["cpu"] * topo.n_chips,
                             ckpt_root=str(tmp_path / "ckpt"),
                             state_path=str(tmp_path / "state.json"))


def _port_of(v):
    """The port's object for a reference object of the JAX package: the
    attribute of the same name in the port's module of the same path; a
    dataclass instance (a ``SimJobSpec``) is rebuilt as the port's class
    with the same fields."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        cls = _port_of(type(v))
        return v if cls is type(v) else cls(**dataclasses.asdict(v))
    mod = getattr(v, "__module__", None) or ""
    if not (isinstance(v, (type, types.FunctionType))
            and mod.startswith("repro.")):
        return v
    port = importlib.import_module("repro_torch" + mod[len("repro"):])
    return getattr(port, v.__name__)


def twins(ref, **helpers):
    """The reference test module's namespace, re-bound to the port: each
    name the module takes from ``repro`` is the port's object, the given
    helpers replace the module's own (its device lists are JAX's), and
    the module's functions run with this namespace.  ``jax`` is None in
    it: a twin never reaches JAX."""
    g = dict(vars(ref))
    for k, v in vars(ref).items():
        if not k.startswith("__") and not isinstance(v, types.ModuleType):
            g[k] = _port_of(v)
    g.update(helpers, jax=None)
    for k, v in vars(ref).items():
        if (isinstance(v, types.FunctionType) and v.__module__ == ref.__name__
                and k not in helpers):
            g[k] = types.FunctionType(v.__code__, g, k, v.__defaults__)
    leaked = [k for k, v in g.items() if not k.startswith("__") and (
        getattr(v, "__module__", None) or "").startswith("repro.")]
    assert not leaked, f"reference objects left in the twins: {leaked}"
    return g


#: the reference preemption tests that build real (xLSTM) blocks: their
#: twins, on deepseek_7b's smoke config, are written out below
REAL_BLOCK_TESTS = ("test_suspend_resume_bit_identical_params",
                    "test_resume_is_a_compile_cache_hit",
                    "test_serve_block_suspend_resume_keeps_decode_context",
                    "test_resume_on_different_geometry")

TWINS = {
    "daemon": (ref_daemon, dict(make_daemon=make_daemon)),
    "engine": (ref_engine, dict(make_daemon=make_daemon)),
    "preemption": (ref_preemption, dict(make_ctl=make_ctl)),
}
TWIN_CASES = [(mod, name) for mod, (ref, _) in TWINS.items()
              for name in sorted(vars(ref))
              if name.startswith("test_") and name not in REAL_BLOCK_TESTS]


def test_twins_cover_the_reference_tests():
    assert [sum(m == mod for m, _ in TWIN_CASES)
            for mod in TWINS] == [8, 11, 18]


@pytest.mark.parametrize("mod,name", TWIN_CASES,
                         ids=[f"{m}-{n}" for m, n in TWIN_CASES])
def test_twin(mod, name, tmp_path):
    ref, helpers = TWINS[mod]
    fn = twins(ref, **helpers)[name]
    kwargs = ({"tmp_path": tmp_path}
              if "tmp_path" in inspect.signature(fn).parameters else {})
    fn(**kwargs)


# --------------------------------------------- the real-block twins

def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, torch.Tensor):
        yield tree


def _bits(tree):
    return [(t.dtype, tuple(t.shape), t.detach().clone()) for t in
            _leaves(tree)]


def _same_bits(a, b):
    return len(a) == len(b) and all(
        da == db and sa == sb and torch.equal(x.view(torch.uint8)
                                              if x.dtype == torch.bfloat16
                                              else x, y.view(torch.uint8)
                                              if y.dtype == torch.bfloat16
                                              else y)
        for (da, sa, x), (db, sb, y) in zip(a, b))


def _train_job(seq_len=16, global_batch=2, microbatch=1):
    shape = ShapeConfig("t", "train", seq_len=seq_len,
                        global_batch=global_batch, microbatch=microbatch)
    return JobSpec(configs.get_smoke("deepseek_7b"), shape,
                   opt=OptConfig(warmup_steps=1, total_steps=8))


def test_suspend_resume_bit_identical_params(tmp_path):
    """Preempt -> resume restores bit-identical state on the real
    runtime."""
    ctl = make_ctl(tmp_path, pod_x=2, pod_y=1)
    a, g = ctl.submit("alice", "train", 1, job=_train_job())
    ctl.step_all(rounds=3)
    rt = ctl.runtimes[a]
    before = _bits(rt.state)
    steps_before = rt.step_count

    ctl.preempt(a, "bit-identity test")
    assert rt.suspended and rt.state is None
    assert ctl.partitioner.free_capacity() == 2     # chips released
    ctl.tick()                                      # auto-resume
    assert ctl.registry.get(a).state == BlockState.RUNNING
    assert rt.step_count == steps_before
    assert _same_bits(before, _bits(rt.state))
    ctl.step_all(rounds=1)
    assert rt.step_count == steps_before + 1


def test_resume_is_a_compile_cache_hit(tmp_path):
    """Resuming on the same chips builds nothing: the rebuilt runtime's
    train step comes out of the compile cache, the Monitor counts the
    hit, and the activation attached the block's roofline, so its MFU
    reads back after two steps."""
    compile_cache.GLOBAL.clear()            # process-wide: isolate the test
    ctl = make_ctl(tmp_path, pod_x=2, pod_y=1)
    a, g = ctl.submit("alice", "train", 1, job=_train_job())
    ctl.step_all(rounds=2)
    first = compile_cache.GLOBAL.stats()
    assert first["misses"] >= 1 and first["hits"] == 0

    ctl.preempt(a, "compile-cache test")
    ctl.tick()                              # auto-resume on the same chips
    assert ctl.registry.get(a).state == BlockState.RUNNING
    after = compile_cache.GLOBAL.stats()
    assert after["misses"] == first["misses"], "resume rebuilt the step"
    assert after["hits"] >= 1
    ctl.step_all(rounds=1)                  # the reused step still steps

    actions = [e.payload["action"]
               for e in ctl.bus.events_since(kinds={"compile"})]
    assert "miss" in actions and "hit" in actions
    rep = ctl.monitor.compile_report()
    assert rep["compile_hits_total"] == after["hits"]
    assert rep["compile_misses_total"] == after["misses"]
    assert rep["compile_hit_rate"] > 0

    blk = ctl.registry.get(a)
    assert ctl.monitor.mfu(blk.block_id) is not None
    roof = ctl.monitor.roofline_report()
    assert blk.block_id in roof["blocks"] and roof["mean_mfu"] > 0
    assert roof["blocks"][blk.block_id]["source"] == "analytic"


def test_serve_block_suspend_resume_keeps_decode_context(tmp_path):
    """A serve block's KV cache, token and cache_len survive preemption:
    without them a restored decoder would restart from an empty cache at
    position 0."""
    ctl = make_ctl(tmp_path, pod_x=2, pod_y=1)
    job = JobSpec(configs.get_smoke("deepseek_7b"),
                  ShapeConfig("s", "serve", seq_len=16, global_batch=2,
                              microbatch=1), kind="serve")
    a, g = ctl.submit("alice", "serve", 1, job=job)
    ctl.step_all(rounds=3)                  # decode 3 tokens
    rt = ctl.runtimes[a]
    rt.drain()
    cache_before, token_before = _bits(rt.cache), rt.token.clone()
    assert rt.cache_len == 3

    ctl.preempt(a, "serve context test")
    assert rt.cache is None and rt.token is None
    ctl.tick()                              # auto-resume
    assert ctl.registry.get(a).state == BlockState.RUNNING
    assert rt.cache_len == 3
    assert torch.equal(rt.token, token_before)
    assert _same_bits(cache_before, _bits(rt.cache))
    ctl.step_all(rounds=1)                  # decoding continues
    assert rt.cache_len == 4


def test_resume_on_different_geometry(tmp_path):
    """Suspend on a (2, 2) 4-chip grant, resume on 2 chips: the block
    keeps its id and its params bit for bit (a port block spans one
    device, here one ``"cpu"`` per chip)."""
    ctl = make_ctl(tmp_path, pod_x=4, pod_y=2)
    a, g = ctl.submit("alice", "train", 4,
                      job=_train_job(seq_len=32, global_batch=4,
                                     microbatch=2))
    assert g.mesh_shape == (2, 2), g.mesh_shape
    ctl.step_all(rounds=2)
    rt = ctl.runtimes[a]
    before = _bits(rt.state["params"])

    ctl.preempt(a, "geometry test")
    grant = ctl.resume(a, n_chips=2)        # resume at half size
    assert grant.mesh_shape in ((1, 2), (2, 1)), grant.mesh_shape
    assert grant.block_id == g.block_id
    assert len(rt.devices) == 2 and rt.grant is grant
    assert rt.step_count == 2
    assert _same_bits(before, _bits(rt.state["params"]))
    ctl.step_all(rounds=1)
    assert rt.step_count == 3
    ctl.partitioner.check_invariants()


def test_chip_failure_and_resize_rebuild_a_real_block(tmp_path):
    """The controller's other runtime paths on a torch block: a chip
    failure re-carves the block and ``BlockRuntime.rebuild`` restores its
    last checkpoint (bit for bit), and an elastic resize saves, rebuilds
    at the new size and steps on."""
    ctl = make_ctl(tmp_path, pod_x=2, pod_y=2)
    a, g = ctl.submit("alice", "train", 2, job=_train_job())
    ctl.step_all(rounds=2)
    rt = ctl.runtimes[a]
    rt.save(async_=False)
    saved = _bits(rt.state)
    ctl.step_all(rounds=1)
    assert ctl.inject_chip_failure(g.coords[0]) == a
    new = ctl.runtimes[a]
    assert new is not rt and ctl.registry.get(a).state == BlockState.RUNNING
    assert g.coords[0] not in ctl.registry.get(a).grant.coords
    assert new.step_count == 2 and _same_bits(saved, _bits(new.state))
    ctl.step_all(rounds=1)
    resized = ctl.resize_block(a, 1)
    assert resized.step_count == 3 and len(resized.devices) == 1
    ctl.step_all(rounds=1)
    assert resized.step_count == 4
    ctl.partitioner.check_invariants()


# =============================================================== parity

def _parity_script(Daemon, Topo, Sim, devices, root):
    """Three users submit on a 2x2 pod, a priority-5 submit preempts,
    ticks auto-resume, one block's period ends, and a gang waits and is
    admitted when another ends; every call on the model clock.  Returns
    the daemon."""
    # steps of no model time: each one is ready at its dispatch, so the
    # order steps are harvested in is the dispatch order, not the host's
    sim = Sim(step_s=0.0, ckpt_every=2)
    d = Daemon(Topo(n_pods=1, pod_x=2, pod_y=2), devices=devices,
               ckpt_root=root)
    a, _ = d.submit("alice", "a", 2, job=sim, now=0.0)
    b, _ = d.submit("bob", "b", 1, job=sim, now=1.0, priority=1)
    c, _ = d.submit("carol", "c", 1, job=sim, now=2.0)
    d.run_steps({a: 3, b: 2, c: 1})
    e, g = d.submit("dave", "urgent", 2, job=sim, priority=5, now=3.0)
    assert g is not None
    d.run_steps({e: 2})
    d.registry.get(e).grant.expires_at = 10.0
    d.tick(now=11.0)                        # dave's period ends: resume
    d.tick(now=12.0)
    d.run_steps(1)
    d.registry.get(b).grant.expires_at = 20.0
    d.tick(now=21.0)                        # bob's period ends
    ids, grants = d.submit_gang("erin", [("g1", 1, sim), ("g2", 1, sim)],
                                now=22.0)
    assert grants is None                   # one chip free: the gang waits
    d.registry.get(c).grant.expires_at = 22.5
    d.tick(now=23.0)                        # carol's ends: the gang co-starts
    d.run_steps(2)
    return d


def _normalised(daemon):
    """(kind, app_id, user, state, payload) per event: block ids and
    tokens renamed in order of appearance, wall times dropped."""
    names = {}

    def norm(v):
        if isinstance(v, str) and (v.startswith(("blk_", "pending_blk_"))
                                   or (len(v) == 32 and all(
                                       c in "0123456789abcdef" for c in v))):
            return names.setdefault(v, f"<id{len(names)}>")
        if isinstance(v, dict):
            return {k: norm(x) for k, x in sorted(v.items())}
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        return v

    out = []
    for ev in daemon.events_since(0, limit=100000):
        payload = {k: v for k, v in ev.payload.items()
                   if k not in ("expires_at", "t")}
        out.append((ev.kind, ev.app_id, ev.user, norm(ev.block_id),
                    payload.get("state"), norm(payload)))
    return out


def test_parity_event_streams_on_both_daemons(tmp_path):
    """The same deterministic script on the reference's daemon (JAX CPU
    devices) and the port's (``"cpu"``): equal event streams, kind by
    kind, app by app, state by state and payload by payload."""
    want = _parity_script(JDaemon, JTopology, JSim,
                          [jax.devices()[0]] * 4, str(tmp_path / "j"))
    got = _parity_script(ClusterDaemon, Topology, SimJobSpec, ["cpu"] * 4,
                         str(tmp_path / "t"))
    w, g = _normalised(want), _normalised(got)
    assert len(g) == len(w) > 50
    for i, (x, y) in enumerate(zip(g, w)):
        assert x == y, (i, x, y)
    kinds = {k for k, *_ in g}
    assert {"preempted", "resumed", "admitted", "enqueued", "step",
            "state", "utilization"} <= kinds
    states = [(app, st) for k, app, _, _, st, _ in g if k == "state"]
    assert ("app_0002", "expired") in states            # bob
    assert ("app_0003", "expired") in states            # carol
    assert ("app_0005", "running") in states            # the gang
    assert ("app_0006", "running") in states


# ================================================ a real block, two daemons

def _f32_smoke(get):
    return dataclasses.replace(get("deepseek_7b"), param_dtype="float32")


def _train_through(daemon_cls, topo_cls, devices, job, root, preempt,
                   init=None):
    """4 steps of ``job`` through ``run_steps``, with a preempt and a
    tick-driven resume after step 2 when ``preempt``; ``init`` installs
    the block's starting state.  Returns the 4 losses."""
    d = daemon_cls(topo_cls(n_pods=1, pod_x=1, pod_y=1), devices=devices,
                   ckpt_root=root)
    a, g = d.submit("alice", "train", 1, job=job)
    rt = d.runtime(a)
    if init is not None:
        init(rt)
    losses = []
    d.bus.subscribe(lambda ev: losses.append(ev.payload["metrics"]["loss"]),
                    kinds={"step"})
    d.run_steps({a: 2})
    if preempt:
        d.preempt(a, "parity test")
        assert d.registry.get(a).state.value == "preempted"
        d.tick()
        assert d.registry.get(a).state.value == "running"
    d.run_steps({a: 2})
    assert rt.step_count == 4
    return losses


def test_real_block_across_a_preemption_on_both_daemons(tmp_path):
    """deepseek_7b's smoke config (fp32 params), a train block with fp32
    moments, stepped 4 times through ``run_steps`` with a preempt and a
    tick-driven resume after step 2: the port's losses are bitwise those
    of its uninterrupted run, and within the train slice's tolerance of
    the reference daemon's on the same job and weights."""
    shape_kw = dict(seq_len=16, global_batch=2, microbatch=1)
    opt_kw = dict(lr=1e-3, warmup_steps=1, total_steps=8, state_bits=None)
    jjob = JJob(_f32_smoke(jconfigs.get_smoke), JShape("t", "train",
                                                       **shape_kw),
                opt=JOpt(**opt_kw), seed=5, collect_metrics=True)
    job = JobSpec(_f32_smoke(configs.get_smoke),
                  ShapeConfig("t", "train", **shape_kw),
                  opt=OptConfig(**opt_kw), seed=5, collect_metrics=True)
    start = {}

    def grab(rt):
        start["params"] = jax.tree.map(np.array, rt.state["params"])

    def install(rt):
        rt.init_state(params=interop.params_from_numpy(start["params"],
                                                       "cpu"))

    want = _train_through(JDaemon, JTopology, [jax.devices()[0]], jjob,
                             str(tmp_path / "j"), preempt=True, init=grab)
    got = _train_through(ClusterDaemon, Topology, ["cpu"], job,
                            str(tmp_path / "t"), preempt=True, init=install)
    straight = _train_through(ClusterDaemon, Topology, ["cpu"], job,
                                 str(tmp_path / "t0"), preempt=False,
                                 init=install)
    assert got == straight                   # bit for bit in the port
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ============================================================ launchers

LAUNCH_ARGV = ["--arch", "deepseek_7b", "--smoke", "--device", "cpu",
               "--steps", "4", "--seq-len", "16", "--global-batch", "2",
               "--log-every", "1", "--ckpt-every", "2"]


def _kinds(daemon, app_id, kind):
    return [e.payload for e in daemon.events_since(0, app_id=app_id,
                                                   limit=100000)
            if e.kind == kind]


def test_train_launcher_through_the_daemon_with_and_without_autostep(
        tmp_path, capsys):
    """``launch.train`` runs its block as a tenant of the daemon: the
    client-driven run and the autostep run (``--autostep --pace``) take
    the same steps, bit for bit, each checkpointing every 2 steps; the
    autostep run's block is driven by the engine at the given pace to
    DONE, and a ``--resume``d autostep run trains on from step 4."""
    def run(d, *extra):
        return launch_train.run(launch_train.parse_args(
            LAUNCH_ARGV + ["--ckpt-dir", str(tmp_path / d), *extra]))

    client = run("c")
    auto = run("a", "--autostep", "--pace", "500")
    losses = [[h["loss"] for h in r["history"]] for r in (client, auto)]
    assert losses[0] == losses[1] and len(losses[0]) == 4
    assert client["checkpoints"] == [2, 4]
    # the engine saves at the first harvest past each interval (the gap
    # between its saves bounded by ckpt_every plus the dispatch window),
    # and the launcher saves the last step
    saves = [0] + auto["checkpoints"]
    assert saves[-1] == 4 and all(
        2 <= b - a <= 2 + auto["daemon"].scheduler.max_inflight
        for a, b in zip(saves[:-2], saves[1:-1])), saves
    for r, driven in ((client, False), (auto, True)):
        d, app = r["daemon"], r["app_id"]
        assert not d.running                        # stopped on return
        states = [p["state"] for p in _kinds(d, app, "state")]
        assert states[:4] == ["approved", "confirmed", "active", "running"]
        assert states[-2:] == ["done", "expired"]
        auto_evs = _kinds(d, app, "autostep")
        assert bool(auto_evs) == driven
        assert len(_kinds(d, app, "step")) == 4
    enabled, done = _kinds(auto["daemon"], auto["app_id"], "autostep")
    assert enabled["action"] == "enabled" and enabled["max_rate_hz"] == 500
    assert enabled["until_steps"] == 4 and done == {"action": "done",
                                                     "steps": 4}
    capsys.readouterr()
    more = run("a", "--autostep", "--resume", "--steps", "6")
    assert more["start_step"] == 4 and len(more["history"]) == 2
    assert more["checkpoints"][-2:] == [4, 6]
    assert "# resumed from step 4" in capsys.readouterr().out


def test_serve_launcher_through_the_daemon():
    """``launch.serve``: a serve block admitted, activated and run by the
    daemon, each decode step one ``run_steps`` dispatch and one step
    event, then expired."""
    res = launch_serve.run(launch_serve.parse_args(
        ["--arch", "deepseek_7b", "--smoke", "--device", "cpu", "--batch",
         "2", "--prompt-len", "8", "--gen", "5"]))
    d, app = res["daemon"], res["app_id"]
    assert res["tokens"].shape == (2, 5) and res["steps"] == 4
    assert len(_kinds(d, app, "step")) == 4
    assert [p["state"] for p in _kinds(d, app, "state")] == [
        "approved", "confirmed", "active", "running", "done", "expired"]
    assert d.registry.get(app).block_id == res["grant"].block_id


# ============================================================= roofline

@pytest.mark.parametrize("arch", ["deepseek_7b", "zamba2_2p7b"])
@pytest.mark.parametrize("kind,seq,batch", [("train", 2048, 2),
                                            ("prefill", 512, 4),
                                            ("decode", 1024, 8)])
def test_block_roofline_is_analytic_on_h100_peaks(arch, kind, seq, batch):
    """The port's roofline: the reference's model FLOPs for the same
    config and shape, on the H100's bf16 peak, never a dry run's."""
    want = jhlo.model_step_flops(jconfigs.get(arch),
                                 JShape("s", kind, seq, batch))
    shape = ShapeConfig("s", kind, seq, batch)
    got = hlo_analysis.block_roofline(configs.get(arch), shape, 1)
    assert got["model_flops"] == want > 0
    assert got["peak_flops"] == hlo_analysis.PEAK_FLOPS == 989e12
    assert hlo_analysis.HBM_BW == 3.35e12
    assert got["source"] == "analytic" and got["bottleneck"] == "compute"
    assert got["step_time_s"] == want / 989e12
    assert not hasattr(hlo_analysis, "dryrun_roofline")


def test_monitor_mfu_of_a_smoke_block_after_two_steps(tmp_path):
    """The controller attaches the analytic roofline at activation (its
    import failing would be swallowed): the Monitor's MFU is non-null
    after two steps and is model FLOPs over the EWMA step time at the
    H100 peak."""
    ctl = make_ctl(tmp_path, pod_x=1, pod_y=1)
    job = _train_job()
    a, g = ctl.submit("alice", "train", 1, job=job)
    assert ctl.monitor.mfu(g.block_id) is None
    ctl.step_all(rounds=2)
    mfu = ctl.monitor.mfu(g.block_id)
    stats = ctl.monitor.stats[g.block_id]
    flops = hlo_analysis.model_step_flops(job.cfg, job.shape)
    assert mfu is not None and mfu > 0
    assert mfu == pytest.approx(flops / (stats.ewma_step_s * 989e12))


# ====================================================== the control phase

def test_chip_smoke_control_phase_on_cpu_race_checked():
    """``chip_smoke.py``'s control phase at smoke size on the CPU, in a
    process with the port's race detector installed (every lock
    instrumented, the daemon-serialized sections asserted single-entry):
    Alice's losses across the preemption are train_hybrid's, Bob's tokens
    serve_paged's, the events in order, and no violation recorded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from repro_torch.analysis import runtime_check
        runtime_check.install()
        import torch
        torch.set_num_threads(1)
        import chip_smoke as c
        train = c.phase_train_hybrid(device="cpu", smoke=True)
        paged = c.phase_serve_paged(device="cpu", smoke=True)
        out = c.phase_control(device="cpu", smoke=True, train=train,
                              paged=paged)
        assert out["alice"]["losses"] == train["losses"]
        assert out["bob"]["tokens"] == 12 * c.PAGED_NEW_TOKENS_SMOKE
        assert out["events"]["preempted"]["checkpoint_step"] == 1
        assert out["events"]["compile_after_preempt"] == ["hit"]
        assert set(out["launches"].values()) == {{0}}
        assert out["alice"]["mfu"] > 0
        assert runtime_check.violations() == [], runtime_check.violations()
        print("CONTROL_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=str(ROOT))
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "CONTROL_OK" in r.stdout


def test_port_analysis_runs_clean_without_a_dashboard():
    """The port's copy of ``analysis`` walks the port by default (its CLI
    gate exits 0) and, with no ``gateway/static/`` yet, finds no
    dashboard JS and reports nothing about it."""
    from repro_torch.analysis import analyze_paths
    from repro_torch.analysis.__main__ import main
    report, model = analyze_paths([str(ROOT / "src" / "repro_torch")])
    assert report.errors() == [] and model["events"]["dashboard"] == []
    assert not any("dashboard" in f.rule for f in report.findings)
    assert main([]) == 0
