"""Several tenant blocks at once on disjoint subsets of the ranks (item 8b),
through the port's controller on gloo ranks on the CPU, against the JAX
package's controller running the same calls: the twin of
``tests/test_multidevice.py``'s ``test_controller_full_lifecycle_and_failover``.

One scenario (``SCENARIO``), run by both controllers on a 2 x 4 pod of 8
chips: alice's dense deepseek_7b train block on 2 chips, bob's hybrid
zamba2_2p7b train block on 2 chips and carol's one-chip dense deepseek_7b
serve block, each activated and run; two rounds of ``step_all``; a save
of alice's; a failure of her first chip, which the shared partitioner
answers by re-carving her onto two chips she never held; a round;
``resize_block(bob, 3)``, which grows him onto a rank that never held
him; a round; expiry.  (A block of 4 chips, a mesh with both axes > 1,
leaves no healthy rectangle of 4 for the re-carve on 8 chips beside the
other two blocks, so alice takes 2, as the partitioner's
``mesh_shape_for`` lays out: (1, 2).)

The JAX side (``REF``) is one subprocess with 8 forced host devices; it
saves each block at step 0, and the port's world starts from those
checkpoints (the two packages draw their inits apart).  The port's side
is a world of 8 gloo ranks (``RANKS``), one chip each, subprocesses
joined through a ``FileStore`` in the test's directory (no port, so
parallel test workers never collide), each with
``torch.set_num_threads(1)``, a subprocess timeout and a collective
timeout; every rank runs the controller and prints one JSON line, which
the tests below read through a module-scoped fixture.  Both sides run at
once.

Configs are the smoke configs in fp32, as ``tests/test_torch_
multidevice.py``'s; losses across the packages at rtol 1e-4 (the same
sizes measured 3e-7 there); everything within the port bit for bit.  The
event streams are compared as ``tests/test_torch_control.py``'s
``_normalised`` compares them, without the wall times (``t``) and the
compile cache's events (each process has its own cache); a step's
``step_s`` and metrics are the block's first rank's on every rank, and
so are the monitor's accounting and a chip-second quota's decision.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu")
WORLD = 8
PROMPT, GEN = 8, 5

torch.set_num_threads(1)

SCENARIO = r'''
import dataclasses
import numpy as np

PROMPT, GEN, NOW = 8, 5, 100.0
USERS = (("alice", "deepseek_7b", 2), ("bob", "zamba2_2p7b", 2),
         ("carol", "deepseek_7b", 1))


def fp32(C, arch):
    return dataclasses.replace(C.get_smoke(arch), param_dtype="float32")


def jobs(C, Job, Shape, Opt):
    train = Shape("t", "train", seq_len=16, global_batch=4, microbatch=2)
    opt = Opt(warmup_steps=2, total_steps=10)
    return {"alice": Job(fp32(C, "deepseek_7b"), train, opt=opt,
                         collect_metrics=True, ckpt_namespace="alice"),
            "bob": Job(fp32(C, "zamba2_2p7b"), train, opt=opt,
                       collect_metrics=True, ckpt_namespace="bob"),
            "carol": Job(fp32(C, "deepseek_7b"),
                         Shape("s", "serve", seq_len=PROMPT + GEN,
                               global_batch=2),
                         kind="serve", ckpt_namespace="carol")}


def prompt(C, Shape, pipeline):
    shape = Shape("s", "prefill", seq_len=PROMPT, global_batch=2)
    return {k: v for k, v in pipeline.synthetic_batch(
        fp32(C, "deepseek_7b"), shape, step=0, seed=0).items()
        if k != "labels"}


def scenario(ctl, job_of, side):
    """The calls both controllers make, in order.  ``side`` gives what
    differs: ``start(apps)`` (the reference saves step 0, the port's
    ranks restore it), ``prefill(rt, batch)`` and ``token(rt)`` (carol's,
    on her rank), ``loss(rec)``, ``moved(name, app)`` (after a
    migration) and ``before_expiry(apps)``."""
    rec = {"grants": {}, "losses": {"alice": [], "bob": []}, "tokens": [],
           "steps": {}}
    apps = {}
    for user, arch, n in USERS:
        a = ctl.register(user, f"{arch} for {user}", n, arch=arch)
        g = ctl.review(a)
        ctl.confirm(a, g.token)
        ctl.activate(a, job_of[user])
        ctl.run(a)
        apps[user] = a
    ctl.partitioner.check_invariants()

    def grants(when):
        rec["grants"][when] = {
            u: [[list(c) for c in ctl.registry.get(a).grant.coords],
                list(ctl.registry.get(a).grant.mesh_shape)]
            for u, a in apps.items()}

    def round_():
        out = ctl.step_all(rounds=1)
        for u in ("alice", "bob"):
            rec["losses"][u].append(side.loss(out[apps[u]][0]))
        rec["tokens"].append(side.token(ctl.runtimes[apps["carol"]]))

    side.start(apps)
    grants("start")
    side.prefill(ctl.runtimes[apps["carol"]])
    rec["tokens"].append(side.token(ctl.runtimes[apps["carol"]]))
    round_()
    round_()
    ctl.runtimes[apps["alice"]].save(async_=False)
    failed = ctl.inject_chip_failure(
        tuple(ctl.registry.get(apps["alice"]).grant.coords[0]), now=NOW)
    rec["failed"] = failed == apps["alice"]
    rec["state_after_failure"] = ctl.registry.get(apps["alice"]).state.value
    rec["steps"]["alice_restored"] = ctl.runtimes[apps["alice"]].step_count
    side.moved("alice", apps["alice"])
    grants("after_failure")
    round_()
    ctl.resize_block(apps["bob"], 3)
    rec["steps"]["bob_restored"] = ctl.runtimes[apps["bob"]].step_count
    side.moved("bob", apps["bob"])
    grants("after_resize")
    round_()
    ctl.partitioner.check_invariants()
    rec["steps"]["end"] = {u: ctl.runtimes[a].step_count
                           for u, a in apps.items()}
    side.before_expiry(apps)
    for a in apps.values():
        ctl.expire(a, now=NOW)
    rec["free_chips"] = len(ctl.partitioner.free_chips())
    return rec
'''

REF = SCENARIO + r'''
import json, os, sys
import repro.configs as C
from repro.core.controller import ClusterController
from repro.core.runtime import JobSpec
from repro.core.topology import Topology
from repro.data import pipeline
from repro.models.config import ShapeConfig
from repro.train.optimizer import OptConfig

root = sys.argv[1]
ctl = ClusterController(Topology(n_pods=1, pod_x=2, pod_y=4), ckpt_root=root)


class Ref:
    def start(self, apps):
        for a in apps.values():
            ctl.runtimes[a].save(async_=False)
        open(os.path.join(root, "init_done"), "w").close()

    def prefill(self, rt):
        rt.prefill(prompt(C, ShapeConfig, pipeline))

    def token(self, rt):
        return np.asarray(rt.token)[:, 0].tolist()

    def loss(self, r):
        return float(r["loss"])

    def moved(self, name, app):
        pass

    def before_expiry(self, apps):
        pass


rec = scenario(ctl, jobs(C, JobSpec, ShapeConfig, OptConfig), Ref())
print("RESULT " + json.dumps(rec))
'''

RANKS = SCENARIO + r'''
import gc, hashlib, json, os, shutil, sys, time
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, root, ref = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
from repro_torch import device as D
D.init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                   world_size=world, timeout_s=240)
import repro_torch.configs as C
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.controller import ClusterController
from repro_torch.core.runtime import BlockRuntime, JobSpec
from repro_torch.core.topology import Topology
from repro_torch.data import pipeline
from repro_torch.models.config import ShapeConfig
from repro_torch.models.transformer import flatten
from repro_torch.train.optimizer import OptConfig
from torch.distributed.tensor import DTensor

out = {"rank": rank, "checks": {}}
events = []
ctl = ClusterController(Topology(n_pods=1, pod_x=2, pod_y=4),
                        devices=["cpu"] * world, ckpt_root=root)
ctl.bus.subscribe(events.append)


def whole(t):
    return t.detach().full_tensor() if isinstance(t, DTensor) else t.detach()


def digests(tree):
    return {p: hashlib.sha256(whole(t).contiguous().reshape(-1).view(
        torch.uint8).numpy().tobytes()).hexdigest() for p, t in flatten(tree)}


def mine(rt):
    return isinstance(rt, BlockRuntime)


def live_groups():
    """Process groups this rank holds besides the world group (what the
    block meshes' pool bounds), from torch's own table of them."""
    from torch.distributed import distributed_c10d as c10d
    return sum(1 for pg in c10d._world.pg_map
               if pg is not dist.group.WORLD)


class Port:
    def start(self, apps):
        # every block from the reference's step-0 checkpoints
        if rank == 0:
            t0 = time.time()
            while not os.path.exists(os.path.join(ref, "init_done")):
                if time.time() - t0 > 240:
                    raise TimeoutError("the reference wrote no step 0")
                time.sleep(0.2)
            for user in apps:
                shutil.copytree(os.path.join(ref, user, "step_00000000"),
                                os.path.join(root, user, "step_00000000"))
        dist.barrier()
        for a in apps.values():
            assert ctl.runtimes[a].restore(step=0) == 0
        out["kinds"] = {u: type(ctl.runtimes[a]).__name__
                        for u, a in apps.items()}
        out["ranks"] = {u: ctl.runtimes[a].ranks for u, a in apps.items()}

    def prefill(self, rt):
        if mine(rt):
            rt.prefill(prompt(C, ShapeConfig, pipeline))

    def token(self, rt):
        return rt.token[:, 0].tolist() if mine(rt) else None

    def loss(self, r):
        return r.get("loss")

    def moved(self, name, app, ns=None):
        # the rebuilt block's state is its checkpoint, bit for bit
        rt = ctl.runtimes[app]
        if not mine(rt):
            return
        like = {"state": rt._abstract_like(), "step_count": 0}
        tree, at = CheckpointManager(root, ns or name).restore(
            like, device="cpu")
        out["checks"][f"{name}_restored_bitwise"] = (
            at == rt.step_count and digests(rt.state) == digests(
                tree["state"]))

    def before_expiry(self, apps):
        gc.collect()
        # what this rank holds: DTensors of its own blocks' meshes only,
        # no state in a stand-in
        held = {tuple(ctl.runtimes[a].ranks) for a in apps.values()
                if mine(ctl.runtimes[a])}
        meshes = [tuple(x.device_mesh.mesh.flatten().tolist())
                  for x in gc.get_objects() if isinstance(x, DTensor)]
        out["checks"]["no_foreign_tensors"] = all(m in held for m in meshes)
        # the scan sees a block's state where the rank holds one (carol's
        # params are DTensors on her (1, 1) mesh too)
        out["checks"]["scan_sees_own_tensors"] = bool(meshes) == any(
            mine(ctl.runtimes[a]) for a in apps.values())
        out["checks"]["stand_ins_hold_nothing"] = all(
            rt.state is None and rt.device is None
            for rt in ctl.runtimes.values() if not mine(rt))
        out["blocks_here"] = sorted(u for u, a in apps.items()
                                    if mine(ctl.runtimes[a]))
        # repeated migrations over the same subsets: no new group, no
        # hang (bob 3 -> 2 -> 3 -> 2 -> 3, a step after)
        groups = [live_groups()]
        for n in (2, 3, 2, 3):
            ctl.resize_block(apps["bob"], n)
            groups.append(live_groups())
        # (carol's cache holds her GEN positions: the train blocks step)
        trains = {apps["alice"]: 1, apps["bob"]: 1}
        ctl.scheduler.run_dispatch(trains)
        out["groups"] = groups
        out["bob_steps_after_cycle"] = ctl.runtimes[apps["bob"]].step_count
        # a preemption and a resume: under a process group a rebuild on
        # the new grant from the suspend's save, every rank in step
        ctl.preempt(apps["alice"], now=NOW)
        ctl.resume(apps["alice"])
        self.moved("alice_resumed", apps["alice"], ns="alice")
        ctl.scheduler.run_dispatch(trains)
        out["alice_steps_after_resume"] = \
            ctl.runtimes[apps["alice"]].step_count
        # a chip-second quota decides alike on every rank: alice's spend
        # (each step as her block's first rank timed it) against a budget
        # of what rank 0 counts; a rank that counted less would admit her
        # second request and hang the grant's broadcast
        used = ctl.scheduler._chip_seconds_by_user()
        out["chip_seconds"] = used
        ctl.scheduler.policy.set_quota(
            "alice", max_chip_seconds=D.from_rank(0, used["alice"]))
        out["quota_admitted"] = ctl.submit(
            "alice", "a second block", 1, now=NOW)[1] is not None
        out["monitor"] = {
            b: [s.steps, s.chip_seconds, s.ewma_step_s, s.last_metrics]
            for b, s in sorted(ctl.monitor.stats.items())}
        out["registry"] = {
            a: [b.state.value, b.block_id, b.failure_reason,
                len(b.preemptions), [note for _, note in b.history]]
            + ([b.grant.token, b.grant.expires_at,
                [list(c) for c in b.grant.coords],
                list(b.grant.mesh_shape)] if b.grant else [])
            for a, b in sorted(ctl.registry.apps.items())}


out["rec"] = scenario(ctl, jobs(C, JobSpec, ShapeConfig, OptConfig), Port())


def norm(ev):
    payload = {k: v for k, v in sorted(ev.payload.items()) if k != "t"}
    return [ev.kind, ev.app_id, ev.user, ev.block_id,
            json.loads(json.dumps(payload, default=str))]


out["events"] = [norm(ev) for ev in events if ev.kind != "compile"]
print("RESULT " + json.dumps(out))
dist.destroy_process_group()
'''


def _collect(procs, timeout):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
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
def world(tmp_path_factory):
    """{"ref": the reference's record, "ranks": each port rank's line,
    "dir": where the port's checkpoints are}."""
    tmp = tmp_path_factory.mktemp("blocks")
    ref, port = tmp / "ref", tmp / "port"
    ref.mkdir(), port.mkdir()
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    jref = subprocess.Popen(
        [sys.executable, "-c", REF, str(ref)],
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = [subprocess.Popen(
            [sys.executable, str(script), str(r), str(WORLD),
             str(tmp / "store"), str(port), str(ref)], env=ENV,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        t0 = time.time()
        out = {"ranks": _collect(ranks, timeout=300)}
        out["ref"] = _collect([jref], timeout=max(10, 300 - (time.time()
                                                            - t0)))[0]
    finally:
        jref.kill()           # a rank that failed leaves no reference behind
    out["dir"], out["ref_dir"] = port, ref
    return out


def test_grants_and_meshes_equal_the_references(world):
    ref = world["ref"]["grants"]
    for r in world["ranks"]:
        assert r["rec"]["grants"] == ref
    # alice re-carved onto chips she never held, bob grown onto one
    start, failed, resized = (ref["start"], ref["after_failure"],
                              ref["after_resize"])
    assert start["alice"][1] == [1, 2] and start["bob"][1] == [1, 2]
    assert not set(map(tuple, failed["alice"][0])) & set(
        map(tuple, start["alice"][0]))
    assert resized["bob"][1] == [1, 3] and len(resized["bob"][0]) == 3
    assert world["ref"]["failed"] and \
        world["ref"]["state_after_failure"] == "running"


def test_disjoint_ranks_each_block_its_own(world):
    ranks = world["ranks"][0]["ranks"]
    assert ranks == {"alice": [0, 1], "bob": [2, 3], "carol": [4]}
    for r in world["ranks"]:
        assert r["ranks"] == ranks
        for user, rs in ranks.items():
            want = "BlockRuntime" if r["rank"] in rs else "OffRankRuntime"
            assert r["kinds"][user] == want


def test_losses_match_the_references(world):
    """Each step's loss as the block's ranks of that step have it (every
    one of them the same) against the reference's."""
    for user in ("alice", "bob"):
        want = world["ref"]["losses"][user]
        assert len(want) == 4
        got = []
        for i in range(4):
            seen = {r["rec"]["losses"][user][i] for r in world["ranks"]}
            seen.discard(None)
            assert len(seen) == 1, (user, i, seen)
            got.append(seen.pop())
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_step_counts_after_the_migration_and_the_resize(world):
    ref = world["ref"]["steps"]
    assert ref["alice_restored"] == 2 and ref["bob_restored"] == 3
    for r in world["ranks"]:
        assert r["rec"]["steps"] == ref
        assert r["rec"]["free_chips"] == world["ref"]["free_chips"] == 7


def test_carol_tokens_equal_the_references_and_her_run_alone(world):
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import BlockRuntime
    got = [r["rec"]["tokens"] for r in world["ranks"]
           if r["rec"]["tokens"][0] is not None]
    assert len(got) == 1 and len(got[0]) == GEN
    assert got[0] == world["ref"]["tokens"]
    # the same serve job alone, with no process group
    g = {}
    exec(SCENARIO, g)
    import repro_torch.configs as C
    from repro_torch.core.runtime import JobSpec
    from repro_torch.data import pipeline
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train.optimizer import OptConfig
    job = g["jobs"](C, JobSpec, ShapeConfig, OptConfig)["carol"]
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), job,
                      devices=["cpu"], ckpt_root=str(world["ref_dir"]))
    rt.restore(step=0)
    rt.prefill(g["prompt"](C, ShapeConfig, pipeline))
    alone = [rt.token[:, 0].tolist()]
    for _ in range(GEN - 1):
        rt.step()
        alone.append(rt.token[:, 0].tolist())
    assert alone == got[0]


def test_migrated_and_resized_blocks_restore_bit_for_bit(world):
    seen = {"alice": 0, "bob": 0, "alice_resumed": 0}
    for r in world["ranks"]:
        for name in seen:
            key = f"{name}_restored_bitwise"
            if key in r["checks"]:
                assert r["checks"][key] is True, (r["rank"], name)
                seen[name] += 1
    assert seen == {"alice": 2, "bob": 3, "alice_resumed": 2}
    for r in world["ranks"]:
        assert r["alice_steps_after_resume"] == 6
    # bob's block never held world rank 0: his first rank wrote the
    # checkpoint his resize restored
    assert (world["dir"] / "bob" / "step_00000003" / "manifest.json").exists()


def test_ids_registry_and_events_equal_on_every_rank(world):
    first = world["ranks"][0]
    kinds = [e[0] for e in first["events"]]
    # 4 rounds of 3 blocks, and the train blocks' after bob's resizes and
    # after alice's resume
    assert kinds.count("step") == 16
    assert {"registered", "state", "step"} <= set(kinds)
    ids = {e[3] for e in first["events"] if e[3]}
    assert len(ids) == 3
    for r in world["ranks"][1:]:
        assert r["registry"] == first["registry"]
        assert len(r["events"]) == len(first["events"])
        for i, (x, y) in enumerate(zip(r["events"], first["events"])):
            assert x == y, (r["rank"], i, x, y)


def test_step_times_and_quota_agree_on_every_rank(world):
    """Each step's time and metrics as the block's first rank has them,
    on every rank: the monitor's chip-seconds and EWMAs are equal, and a
    chip-second quota of rank 0's count waitlists alice's second request
    on every rank alike."""
    first = world["ranks"][0]
    assert first["chip_seconds"]["alice"] > 0
    assert all(b[0] > 0 and b[2] > 0 for b in first["monitor"].values())
    for r in world["ranks"]:
        assert r["chip_seconds"] == first["chip_seconds"], r["rank"]
        assert r["monitor"] == first["monitor"], r["rank"]
        assert r["quota_admitted"] is False
    queued = [row for row in first["registry"].values()
              if row[0] == "queued"]
    assert len(queued) == 1 and "quota" in queued[0][4][-1]
    steps = [e for e in first["events"] if e[0] == "step"]
    assert all(e[4]["step_s"] > 0 for e in steps)
    assert all("loss" in e[4]["metrics"] for e in steps
               if e[2] in ("alice", "bob"))


def test_ranks_outside_a_block_hold_nothing_of_it(world):
    for r in world["ranks"]:
        assert r["checks"]["no_foreign_tensors"], r["rank"]
        assert r["checks"]["scan_sees_own_tensors"], r["rank"]
        assert r["checks"]["stand_ins_hold_nothing"], r["rank"]
    held = {r["rank"]: r["blocks_here"] for r in world["ranks"]}
    # after the migration and the resize: alice on 5, 6, bob on 1, 2, 3,
    # carol on 4; rank 0 (the failed chip) and 7 hold nothing
    assert held == {0: [], 1: ["bob"], 2: ["bob"], 3: ["bob"],
                    4: ["carol"], 5: ["alice"], 6: ["alice"], 7: []}


def test_repeated_migrations_create_no_groups(world):
    for r in world["ranks"]:
        g = r["groups"]
        # the first move to 2 chips may build that mesh's groups; the
        # three after it reuse the meshes of subsets held before
        assert g[1] == g[2] == g[3] == g[4], (r["rank"], g)
        assert r["bob_steps_after_cycle"] == 5


# ------------------------------------------------------------- in process

@pytest.fixture
def fake_world():
    """A fake process group of 4 ranks (this process rank 0), destroyed
    after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _job(kind, paged=False):
    import repro_torch.configs as C
    from repro_torch.core.runtime import JobSpec
    from repro_torch.models.config import ShapeConfig
    return JobSpec(C.get_smoke("deepseek_7b"),
                   ShapeConfig("s", kind, 16, 2), kind=kind, paged=paged)


def test_chips_map_onto_ranks(fake_world):
    from repro_torch.device import Chip, block_ranks, chips
    got = chips(["cpu"] * 6 + [Chip(3, "cpu")])
    assert [c.rank for c in got] == [0, 1, 2, 3, 0, 1, 3]
    assert all(isinstance(c, Chip) for c in got)
    assert block_ranks([Chip(2, "cpu"), Chip(0, "cpu")]) == [2, 0]
    assert block_ranks(["cpu", "cpu", "cpu"]) == [0, 1, 2]
    with pytest.raises(ValueError, match="at most one chip of each rank"):
        block_ranks([got[0], got[4]])


def test_chips_without_a_process_group_are_the_devices():
    import torch.distributed as dist
    from repro_torch.device import chips
    assert not dist.is_initialized()
    assert chips(["cpu", "meta"]) == ["cpu", "meta"]


def test_a_block_holding_two_chips_of_one_rank_raises(fake_world):
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.controller import ClusterController
    from repro_torch.core.runtime import BlockRuntime
    from repro_torch.core.topology import Topology
    from repro_torch.device import Chip
    grant = BlockGrant.new([(0, 0, 0), (0, 1, 0)], (1, 2), 60.0)
    with pytest.raises(ValueError, match="at most one chip of each rank"):
        BlockRuntime(grant, _job("train"),
                     devices=[Chip(1, "cpu"), Chip(1, "cpu")])
    # through the controller: 8 chips on 4 ranks, a block of chips 0 and 4
    ctl = ClusterController(Topology(n_pods=1, pod_x=8, pod_y=1),
                            devices=["cpu"] * 8, ckpt_root="unused")
    assert [ctl.devices_for([(0, i, 0)])[0].rank for i in range(8)] == \
        [0, 1, 2, 3, 0, 1, 2, 3]
    with pytest.raises(ValueError, match="at most one chip of each rank"):
        ctl._runtime(BlockGrant.new([(0, 0, 0), (0, 4, 0)], (1, 2), 60.0),
                     _job("train"))


@pytest.mark.parametrize("paged", [False, True])
def test_a_serve_blocks_stand_in_holds_nothing_and_names_8f(fake_world,
                                                            paged,
                                                            monkeypatch):
    """A serve block of two ranks as a rank outside it follows it (item
    8f, the daemon's service mode across ranks): no state, no device, no
    group.  A paged block's sessions are mirrored: ``start_session`` takes
    the scheduler's ids and checks, ``sessions.has_work`` and
    ``idle_serve`` follow the emissions ``harvest`` receives from the
    block's first rank (its broadcast stood in for here: a fake group
    carries nothing).  A dense block has no session surface, as on its
    own ranks, and its prefill, like a client-driven ``feed``, raises
    here."""
    from repro_torch.core.block import BlockGrant
    from repro_torch.core.runtime import OffRankRuntime
    from repro_torch.device import Chip
    from repro_torch.serve import decode_scheduler
    grant = BlockGrant.new([(0, 1, 0), (0, 2, 0)], (2, 1), 60.0)
    rt = OffRankRuntime(grant, _job("serve", paged),
                        devices=[Chip(1, "cpu"), Chip(2, "cpu")])
    assert rt.ranks == [1, 2] and rt.mesh.get_coordinate() is None
    assert rt.state is None and rt.device is None
    rt.init_state()
    assert rt.state is None
    for call in (rt.feed, lambda: rt.prefill({})):
        with pytest.raises(NotImplementedError, match="outside them"):
            call()
    if not paged:
        assert rt.sessions is None and rt.idle_serve is False
        assert rt.harvest() == []
        with pytest.raises(ValueError, match="no generate surface"):
            rt.start_session([1, 2])
        rt.release()
        return
    assert rt.idle_serve is True and not rt.sessions.has_work
    assert [rt.start_session([1, 2]), rt.start_session([3])] == \
        ["g000000", "g000001"]
    with pytest.raises(ValueError, match="non-empty"):
        rt.start_session([])
    with pytest.raises(ValueError, match="max_seq_len"):
        rt.start_session(list(range(16)))
    assert rt.sessions.has_work and rt.idle_serve is False
    sent = [[{"event": "admitted", "session": "g000000"},
             {"event": "token", "session": "g000000", "token": 7},
             {"event": "admitted", "session": "g000001"},
             {"event": "finished", "session": "g000000"}],
            [{"event": "evicted", "session": "g000001"}],
            [{"event": "admitted", "session": "g000001"},
             {"event": "finished", "session": "g000001"}]]
    seen = []

    def first_ranks(src, emissions):
        assert src == 1 and emissions is None
        seen.append(sent[len(seen)])
        return seen[-1]

    monkeypatch.setattr(decode_scheduler, "emissions_from", first_ranks)
    assert rt.harvest() == sent[0]
    assert rt.sessions.running == {"g000001"} and not rt.sessions.queued
    assert rt.harvest() == sent[1]
    assert rt.sessions.queued == ["g000001"] and rt.idle_serve is False
    assert rt.harvest() == sent[2] and rt.idle_serve is True
    assert rt.start_session([4]) == "g000002"
    rt.release()


def test_tick_without_a_model_time_raises_across_ranks(fake_world):
    """Under several ranks a direct caller gives ``tick`` the time (each
    rank's wall clock is its own); the message points at the leader's
    daemon, which gives every tick its ``now``."""
    from repro_torch.core.controller import ClusterController
    from repro_torch.core.topology import Topology
    ctl = ClusterController(Topology(n_pods=1, pod_x=4, pod_y=1),
                            devices=["cpu"] * 4, ckpt_root="unused")
    with pytest.raises(NotImplementedError,
                       match="core.service.ServiceDaemon"):
        ctl.tick()
    assert ctl.tick(now=0.0) == []


def test_chip_smoke_blocks_phase_on_cpu():
    """``chip_smoke.py``'s blocks phase at smoke size on the CPU (gloo, one
    rank, three chips on it), after ``train_sharded`` as on the card (a
    world destroyed, a new one begun): alice's losses and grad norms are
    train_f32's bit for bit, her third step after the migration among
    them, carol's tokens serve_hybrid's."""
    root = os.path.join(os.path.dirname(__file__), "..")
    code = f"""
import sys
sys.path.insert(0, {os.path.abspath(root)!r})
import torch
torch.set_num_threads(1)
import chip_smoke as c
c.phase_train_sharded(device="cpu", smoke=True)
train = c.phase_train_f32(device="cpu", smoke=True)
serve = c.phase_serve_hybrid(device="cpu", smoke=True)
out = c.phase_blocks(device="cpu", smoke=True, train=train, serve=serve)
assert out["alice"]["losses"] == train["losses"]
assert out["alice"]["grad_norms"] == train["grad_norms"]
assert out["carol"]["tokens"] == serve["tokens"]
assert out["alice"]["migrated_to"] == [[0, 2, 0]]
assert out["alice"]["restored_bitwise"] is True
assert set(out["launches"].values()) == {{0}}
import torch.distributed as dist
assert not dist.is_initialized()
print("BLOCKS_OK")
"""
    env = dict(ENV, PYTHONPATH=os.path.abspath(SRC))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=root)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "BLOCKS_OK" in r.stdout
