"""The daemon's service mode across ranks (item 8f, ``core.service``) on
gloo ranks on the CPU, against the JAX package's background daemon and
gateway running the same HTTP calls.

One scenario (``SCENARIO``), driven over HTTP by a client on the
gateway's process, on a 4 x 1 pod of 4 chips, chip *i* rank *i*: carol
holds chip 0 with a block of no job, so alice's fp32 smoke deepseek_7b
train block (2 chips) lands on ranks 1 and 2 and bob's one-chip paged
serve block on rank 3; both start from the reference's step-0
checkpoints (``daemon.restore``; the packages draw their inits apart);
alice autosteps to 3 steps while bob's 6 sessions run as concurrent
generate requests (5 SSE streams, one long-poll); root preempts bob
after a third of the tokens and the pump's tick resumes him; alice and
carol expire over HTTP, and dave's block of one second expires on a
tick.  It runs three times, at once:

* ``REF``: the reference's ``ClusterDaemon(background=True)`` and its
  ``GatewayServer`` in one JAX process with 4 forced host devices (which
  first writes both jobs' step 0);
* ``RANKS``: 4 gloo ranks, subprocesses joined through a ``FileStore``
  in the test's directory (``torch.set_num_threads(1)``, a subprocess
  timeout, a collective timeout), rank 0's ``ServiceDaemon`` leading in
  background mode behind its ``GatewayServer`` on 127.0.0.1, ranks 1-3
  following; each rank prints one JSON line;
* ``ONE``: the port's one-process ``ClusterDaemon`` and gateway, in this
  process.

Held: every session's tokens equal the reference's and the one-process
run's (greedy, fp32), on blocks whose ranks exclude rank 0; each of
alice's losses within rtol 1e-4 of the reference's (the sizes of
``tests/test_torch_blocks.py``); each app's lifecycle events (kinds, and
states or actions, in order) equal the reference's, without step,
compile, generate and session events, whose count or interleaving
depends on timing (the sessions are held by their tokens); every
rank's registry and whole event stream, step events included, equal
rank 0's (without wall times and the compile cache's events); no
tripwire fired and every rank followed entries.

A second world of 2 gloo ranks (``PAIR``) holds ``launch.train
--autostep`` against the run without it, the ``idle_serve`` repair
(every rank's ``idle_serve`` and step count for an idle paged block
equal its ranks', across a session's life, under ``autostep_round(now=)``)
and a follower that diverges, which raises at the first entry after.
In process: the tripwires and the pickle check at world 1, and
``chip_smoke.py``'s ``service`` phase at smoke size.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu")
WORLD = 4

torch.set_num_threads(1)

SCENARIO = r'''
import dataclasses, json, os, shutil, threading, time
import urllib.error, urllib.request

PROMPTS = ([5, 6, 7], [9, 9], [1, 2, 3, 4], [11], [7, 8, 9, 10, 11],
           [3, 1])
MAX_NEW = 8
ALICE_STEPS = 3
ALICE_JOB = {"kind": "train", "arch": "deepseek_7b", "seq_len": 16,
             "global_batch": 4, "microbatch": 2}
BOB_JOB = {"kind": "serve", "arch": "deepseek_7b", "paged": True,
           "page_size": 4, "max_slots": 4, "seq_len": 32,
           "global_batch": 1}
USERS = (("alice", "tok-alice", False), ("bob", "tok-bob", False),
         ("carol", "tok-carol", False), ("dave", "tok-dave", False),
         ("root", "tok-root", True))
WAIT_S = 240.0


def patch(configs, handlers):
    """fp32 smoke configs, and each real job's checkpoint namespace its
    kind (where the reference's step 0 lies), a train job's steps
    carrying their metrics."""
    get, parse = configs.get_smoke, handlers.parse_job
    configs.get_smoke = lambda arch: dataclasses.replace(
        get(arch), param_dtype="float32")

    def parse_job(spec):
        job = parse(spec)
        if getattr(job, "kind", None) not in ("train", "serve"):
            return job
        return dataclasses.replace(job, ckpt_namespace=job.kind,
                                   collect_metrics=job.kind == "train")
    handlers.parse_job = parse_job


def profiles(store, user):
    return store([user(u, t, admin=a) for u, t, a in USERS])


def copy_step0(src, root):
    for ns in ("train", "serve"):
        shutil.copytree(os.path.join(src, ns, "step_00000000"),
                        os.path.join(root, ns, "step_00000000"))


class Http:
    def __init__(self, url):
        self.url = url

    def _open(self, method, path, token, body):
        r = urllib.request.Request(
            self.url + path, method=method,
            data=None if body is None else json.dumps(body).encode())
        if token:
            r.add_header("Authorization", f"Bearer {token}")
        return urllib.request.urlopen(r, timeout=WAIT_S)

    def req(self, method, path, token=None, body=None, code=200):
        try:
            with self._open(method, path, token, body) as resp:
                status, out = resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            status, out = e.code, json.loads(e.read())
        assert status == code, (method, path, status, out)
        return out

    def stream(self, path, token, body):
        frames, cur = [], {}
        with self._open("POST", path, token, body) as resp:
            for raw in resp:
                line = raw.decode().rstrip("\n")
                if line.startswith("event: "):
                    cur["event"] = line[7:]
                elif line.startswith("data: "):
                    cur["data"] = json.loads(line[6:])
                elif line == "" and "data" in cur:
                    frames.append(cur)
                    cur = {}
        return frames


def until(cond, what):
    t0 = time.time()
    while not cond():
        assert time.time() - t0 < WAIT_S, f"no {what} in {WAIT_S} s"
        time.sleep(0.01)


def scenario(http, daemon):
    """The calls every side makes, in order, over HTTP (and a restore of
    each real block's step 0 through the daemon); the waits read the
    side's own bus.  Returns the side's record."""
    def evs(app, kind, **payload):
        return [e for e in daemon.events_since(0, app_id=app, limit=1 << 20)
                if e.kind == kind and all(e.payload.get(k) == v
                                          for k, v in payload.items())]

    def submit(token, n, job=None, **kw):
        return http.req("POST", "/v1/submit", token, dict(
            job_description="scenario", n_chips=n, job=job, **kw),
            code=201)["app_id"]

    carol = submit("tok-carol", 1)
    alice = submit("tok-alice", 2, ALICE_JOB)
    daemon.restore(alice)
    bob = submit("tok-bob", 1, BOB_JOB)
    daemon.restore(bob)
    apps = {"alice": alice, "bob": bob, "carol": carol}
    grants = {u: http.req("GET", f"/v1/blocks/{a}", "tok-root")["coords"]
              for u, a in apps.items()}
    http.req("POST", f"/v1/blocks/{alice}/autostep", "tok-alice",
             {"until_steps": ALICE_STEPS})
    # armed before the sessions: each generate request arms an unarmed
    # block itself, and concurrent ones would race to (one event each)
    http.req("POST", f"/v1/blocks/{bob}/autostep", "tok-bob", {})
    gen = f"/v1/blocks/{bob}/generate"
    out = [None] * len(PROMPTS)

    def sse(i):
        frames = http.stream(gen, "tok-bob", {"prompt": PROMPTS[i],
                                              "max_new_tokens": MAX_NEW})
        out[i] = [f["data"]["token"] for f in frames
                  if f["event"] == "generate"]

    def poll(i):
        cursor = http.req("GET", f"/v1/blocks/{bob}/events?kinds=state",
                          "tok-bob")["next_after"]
        r = http.req("POST", gen, "tok-bob", {
            "prompt": PROMPTS[i], "max_new_tokens": MAX_NEW,
            "stream": False})
        tokens, done = list(r["tokens"]), r["done"]
        while not done:         # a long-poll that ended before its session
            page = http.req("GET", f"/v1/blocks/{bob}/events?after="
                            f"{cursor}&kinds=generate&timeout_s=30",
                            "tok-bob")
            cursor = page["next_after"]
            for ev in page["events"]:
                if (ev.get("session") == r["session"]
                        and ev["index"] >= len(tokens)):
                    tokens.append(ev["token"])
                    done = ev["done"]
        out[i] = tokens

    threads = [threading.Thread(target=poll if i == len(PROMPTS) - 1
                                else sse, args=(i,), daemon=True)
               for i in range(len(PROMPTS))]
    for th in threads:
        th.start()
    until(lambda: len(evs(bob, "generate")) >= len(PROMPTS) * MAX_NEW // 3
          or not any(th.is_alive() for th in threads), "third of the tokens")
    http.req("POST", f"/v1/blocks/{bob}/preempt", "tok-root",
             {"reason": "admin over http"})
    for th in threads:
        th.join(WAIT_S)
    until(lambda: evs(bob, "resumed"), "bob's resume by the tick")
    until(lambda: evs(alice, "state", state="done"), "alice's last step")
    download = http.req("GET", f"/v1/blocks/{alice}/download", "tok-alice")
    http.req("POST", f"/v1/blocks/{alice}/expire", "tok-alice", {})
    http.req("POST", f"/v1/blocks/{carol}/expire", "tok-carol", {})
    dave = submit("tok-dave", 1, duration_s=1.0)
    apps["dave"] = dave
    until(lambda: evs(dave, "state", state="expired"), "dave's expiry")
    until(lambda: len(evs(bob, "session", action="finished"))
          == len(PROMPTS), "the end of bob's sessions")
    http.req("POST", f"/v1/blocks/{bob}/expire", "tok-bob", {})
    until(lambda: evs(bob, "autostep", action="disabled"),
          "bob's drive to end")
    losses = [e.payload["metrics"]["loss"] for e in evs(alice, "step")]
    lifecycle = {}
    for user, app in apps.items():
        lifecycle[user] = [
            [e.kind, e.payload.get("state", e.payload.get("action"))]
            for e in daemon.events_since(0, app_id=app, limit=1 << 20)
            if e.kind not in ("step", "compile", "generate", "session")]
    return {"apps": apps, "grants": grants, "tokens": out,
            "losses": losses, "download_steps": download["steps"],
            "lifecycle": lifecycle}
'''

REF = SCENARIO + r'''
import sys
import jax
import repro.configs as C
from repro.core.block import BlockGrant
from repro.core.daemon import ClusterDaemon
from repro.core.runtime import BlockRuntime
from repro.core.topology import Topology
from repro.gateway import GatewayServer, ProfileStore, UserProfile
from repro.gateway import handlers

root = sys.argv[1]
patch(C, handlers)
devs = jax.devices()
init = os.path.join(root, "init")
for spec, coords in ((ALICE_JOB, [(0, 1, 0), (0, 2, 0)]),
                     (BOB_JOB, [(0, 3, 0)])):
    grant = BlockGrant.new(coords, (1, len(coords)), 60.0)
    rt = BlockRuntime(grant, handlers.parse_job(spec),
                      [devs[c[1]] for c in coords], init)
    rt.init_state()
    rt.save(async_=False)
run = os.path.join(root, "run")
copy_step0(init, run)
open(os.path.join(root, "init_done"), "w").close()
daemon = ClusterDaemon(Topology(n_pods=1, pod_x=4, pod_y=1), devices=devs,
                       ckpt_root=run, background=True)
server = GatewayServer(daemon, profiles(ProfileStore, UserProfile)).start()
try:
    rec = scenario(Http(server.url), daemon)
finally:
    server.stop()
    daemon.stop()
print("RESULT " + json.dumps(rec))
'''

RANKS = SCENARIO + r'''
import sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, root, ref = (int(sys.argv[1]), int(sys.argv[2]),
                                 sys.argv[3], sys.argv[4], sys.argv[5])
from repro_torch import device as D
D.init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                   world_size=world, timeout_s=240)
import repro_torch.configs as C
from repro_torch.core.runtime import BlockRuntime
from repro_torch.core.service import ServiceDaemon
from repro_torch.core.topology import Topology
from repro_torch.gateway import GatewayServer, ProfileStore, UserProfile
from repro_torch.gateway import handlers

patch(C, handlers)
if rank == 0:
    until(lambda: os.path.exists(os.path.join(ref, "init_done")),
          "the reference's step 0")
    copy_step0(os.path.join(ref, "init"), root)
dist.barrier()
events = []
daemon = ServiceDaemon(Topology(n_pods=1, pod_x=4, pod_y=1),
                       devices=["cpu"] * world, ckpt_root=root)
daemon.bus.subscribe(events.append)
kinds = {}


def on_state(ev):
    if ev.payload["state"] == "running":
        kinds[ev.app_id] = type(daemon.runtime(ev.app_id)).__name__


daemon.bus.subscribe(on_state, kinds={"state"})
out = {"rank": rank}
if rank == 0:
    daemon.start()      # its pump, once every event is watched
    server = GatewayServer(daemon, profiles(ProfileStore, UserProfile)
                           ).start()
    try:
        out["rec"] = scenario(Http(server.url), daemon)
    finally:
        server.stop()
        daemon.stop()
else:
    daemon.follow()
out["log"] = daemon.log_stats()
out["kinds"] = kinds


def norm(ev):
    payload = {k: v for k, v in sorted(ev.payload.items()) if k != "t"}
    return [ev.kind, ev.app_id, ev.user, ev.block_id,
            json.loads(json.dumps(payload, default=str))]


out["events"] = [norm(ev) for ev in events
                 if ev.kind not in ("compile", "postmortem")]
out["registry"] = {
    a: [b.state.value, b.block_id, b.failure_reason,
        [{k: v for k, v in p.items() if k != "t"} for p in b.preemptions],
        [note for _, note in b.history], b.queued_at, b.deadline_at]
    + ([b.grant.token, b.grant.expires_at,
        [list(c) for c in b.grant.coords]] if b.grant else [])
    for a, b in sorted(daemon.registry.apps.items())}
print("RESULT " + json.dumps(out))
dist.destroy_process_group()
'''

PAIR = r'''
import dataclasses, json, os, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store, root = (int(sys.argv[1]), int(sys.argv[2]),
                            sys.argv[3], sys.argv[4])
from repro_torch import device as D
D.init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                   world_size=world, timeout_s=240)
import repro_torch.configs as C
from repro_torch.core.daemon import ClusterDaemon
from repro_torch.core.runtime import JobSpec
from repro_torch.core.service import Divergence, ServiceDaemon
from repro_torch.core.topology import Topology
from repro_torch.launch import train
from repro_torch.models.config import ShapeConfig

out = {"rank": rank}
# ---- idle_serve: a one-chip paged block on rank 1, every rank's daemon
# making the same deterministic calls on the model clock
d = ClusterDaemon(Topology(n_pods=1, pod_x=2, pod_y=1),
                  devices=["cpu"] * world, ckpt_root=os.path.join(root, "i"))
cfg = dataclasses.replace(C.get_smoke("deepseek_7b"), param_dtype="float32")
job = JobSpec(cfg, ShapeConfig("s", "serve", 32, 1), kind="serve",
              paged=True, page_size=4, max_slots=2)
d.submit("carol", "hold", 1, now=0.0)
bob, _ = d.submit("bob", "serve", 1, job=job, now=0.0)
d.autostep_enable(bob, now=0.0)
trace, reads, t = [], [], 1.0
# each idle_serve the engine reads (after its harvest, before dispatch)
from repro_torch.core import runtime as R
for cls in (R.BlockRuntime, R.OffRankRuntime):
    was = cls.__dict__["idle_serve"]
    cls.idle_serve = property(lambda self, was=was: reads.append(
        was.fget(self) if isinstance(was, property) else was) or reads[-1])


def snap(what):
    rt = d.runtime(bob)
    trace.append([what, list(reads), rt.step_count, rt.inflight_depth,
                  type(rt).__name__])
    reads.clear()


for _ in range(3):
    d.autostep_round(now=t)
    t += 1.0
    snap("idle")
sid = d.generate(bob, [5, 6, 7], max_new_tokens=4, now=t)
snap("submitted")
for _ in range(8):
    d.autostep_round(now=t)
    t += 1.0
    snap("round")
out["idle"] = trace
out["sid"] = sid
out["tokens"] = [e.payload["token"] for e in d.events_since(
    0, app_id=bob, kinds={"generate"})]
d.expire(bob, now=t)
# ---- the launcher, without and with --autostep
argv = ["--arch", "deepseek_7b", "--smoke", "--device", "cpu", "--steps",
        "4", "--seq-len", "16", "--global-batch", "4", "--log-every", "1",
        "--ckpt-every", "2"]
runs = {}
for name, extra in (("client", []), ("auto", ["--autostep"])):
    r = train.run(train.parse_args(
        argv + ["--ckpt-dir", os.path.join(root, name)] + extra))
    runs[name] = {"losses": [h["loss"] for h in r["history"]],
                  "checkpoints": r["checkpoints"],
                  "start_step": r["start_step"],
                  "daemon": type(r["daemon"]).__name__,
                  "log": getattr(r["daemon"], "log_stats", dict)()}
out["launcher"] = runs
# ---- a follower that diverges: rank 1's bus has one event more
s = ServiceDaemon(Topology(n_pods=1, pod_x=2, pod_y=1),
                  devices=["cpu"] * world, ckpt_root=os.path.join(root, "d"))
if rank == 0:
    s.register("alice", "after the divergence", 1)
    s.stop()
else:
    s.bus.publish("state", app_id="stray", state="requested")
    try:
        s.follow()
        out["tripwire"] = None
    except Divergence as e:
        out["tripwire"] = str(e)
        out["stop"] = D.to_ranks(None).op      # the leader's last entry
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


def _one_process(tmp, ref):
    """The scenario on the port's one-process daemon and gateway (no
    process group), from the reference's step 0."""
    import repro_torch.configs as C
    from repro_torch.core.daemon import ClusterDaemon
    from repro_torch.core.topology import Topology
    from repro_torch.gateway import GatewayServer, ProfileStore, UserProfile
    from repro_torch.gateway import handlers
    g = {}
    exec(SCENARIO, g)
    saved = (C.get_smoke, handlers.parse_job)
    g["patch"](C, handlers)
    try:
        g["until"](lambda: (ref / "init_done").exists(),
                   "the reference's step 0")
        root = tmp / "one"
        g["copy_step0"](str(ref / "init"), str(root))
        daemon = ClusterDaemon(Topology(n_pods=1, pod_x=4, pod_y=1),
                               devices=["cpu"] * 4, ckpt_root=str(root),
                               background=True)
        server = GatewayServer(daemon, g["profiles"](
            ProfileStore, UserProfile)).start()
        try:
            return g["scenario"](g["Http"](server.url), daemon)
        finally:
            server.stop()
            daemon.stop()
    finally:
        C.get_smoke, handlers.parse_job = saved


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """{"ref": the reference's record, "ranks": each port rank's line,
    "one": the port's one-process record}."""
    tmp = tmp_path_factory.mktemp("service")
    ref, port = tmp / "ref", tmp / "port"
    ref.mkdir(), port.mkdir()
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    jref = subprocess.Popen(
        [sys.executable, "-c", REF, str(ref)],
        env=dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ranks = []
    try:
        ranks = [subprocess.Popen(
            [sys.executable, str(script), str(r), str(WORLD),
             str(tmp / "store"), str(port), str(ref)], env=ENV,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(WORLD)]
        t0 = time.time()
        out = {"one": _one_process(tmp, ref)}
        out["ranks"] = _collect(ranks, timeout=300)
        out["ref"] = _collect([jref], timeout=max(10, 300 - (time.time()
                                                            - t0)))[0]
    finally:
        jref.kill()
        for p in ranks:
            p.kill()
    return out


def test_blocks_land_on_ranks_other_than_the_gateways(world):
    rec = world["ranks"][0]["rec"]
    assert rec["grants"] == world["ref"]["grants"] == world["one"]["grants"]
    assert rec["grants"] == {"alice": [[0, 1, 0], [0, 2, 0]],
                             "bob": [[0, 3, 0]], "carol": [[0, 0, 0]]}
    apps = rec["apps"]
    for r in world["ranks"]:
        want = {apps["alice"]: ("BlockRuntime" if r["rank"] in (1, 2)
                                else "OffRankRuntime"),
                apps["bob"]: ("BlockRuntime" if r["rank"] == 3
                              else "OffRankRuntime")}
        assert r["kinds"] == want, r["rank"]


def test_sessions_answer_from_rank_0_with_the_references_tokens(world):
    """Each session's tokens, streamed by rank 0's gateway from a block on
    rank 3, across a preemption: the reference gateway's and the port's
    one-process gateway's, greedy, fp32."""
    got = world["ranks"][0]["rec"]["tokens"]
    assert all(len(t) == 8 for t in got), got
    assert got == world["ref"]["tokens"]
    assert got == world["one"]["tokens"]


def test_train_losses_match_the_references(world):
    rec, ref = world["ranks"][0]["rec"], world["ref"]
    assert len(rec["losses"]) == len(ref["losses"]) == 3
    assert rec["download_steps"] == ref["download_steps"] == 3
    np.testing.assert_allclose(rec["losses"], ref["losses"], rtol=1e-4)
    np.testing.assert_allclose(world["one"]["losses"], ref["losses"],
                               rtol=1e-4)


def test_lifecycle_events_equal_the_references(world):
    rec, ref = world["ranks"][0]["rec"], world["ref"]
    assert rec["lifecycle"] == ref["lifecycle"]
    assert world["one"]["lifecycle"] == ref["lifecycle"]
    bob = [k for k, _ in rec["lifecycle"]["bob"]]
    assert bob.count("preempted") == bob.count("resumed") == 1
    assert rec["lifecycle"]["dave"][-1] == ["state", "expired"]
    assert ["autostep", "done"] in rec["lifecycle"]["alice"]


def test_every_rank_has_rank_0s_registry_and_event_stream(world):
    first = world["ranks"][0]
    kinds = [e[0] for e in first["events"]]
    assert kinds.count("step") >= 3 and kinds.count("generate") == 48
    assert {"utilization", "preempted", "resumed", "session"} <= set(kinds)
    for r in world["ranks"][1:]:
        assert r["registry"] == first["registry"], r["rank"]
        assert len(r["events"]) == len(first["events"]), r["rank"]
        for i, (x, y) in enumerate(zip(r["events"], first["events"])):
            assert x == y, (r["rank"], i, x, y)


def test_every_rank_followed_the_log_and_no_tripwire_fired(world):
    logs = [r["log"] for r in world["ranks"]]
    assert all(lg["diverged"] is None for lg in logs)
    assert logs[0]["send_s"] > 0
    # every entry reached every rank, the last one (stop) included
    assert len({lg["log_entries"] for lg in logs}) == 1
    assert len({lg["log_bytes"] for lg in logs}) == 1
    assert logs[0]["log_entries"] > 0


# ================================================================ PAIR

@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pair")
    script = tmp / "pair.py"
    script.write_text(PAIR)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(tmp / "store"),
         str(tmp)], env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    return _collect(procs, timeout=300)


def test_idle_serve_and_steps_follow_the_blocks_ranks(pair):
    """A one-chip paged block on rank 1 under the engine, its rounds on
    the model clock: rank 0 (outside the block) reads ``idle_serve`` and
    counts steps as rank 1 does, idle before the session, busy through
    its life, idle after, so both dispatch the same rounds."""
    r0, r1 = pair
    assert r0["sid"] == r1["sid"] == "g000000"
    assert r0["tokens"] == r1["tokens"] and len(r0["tokens"]) == 4
    strip = [[row[:4] for row in r["idle"]] for r in (r0, r1)]
    assert strip[0] == strip[1]
    assert {row[4] for row in r0["idle"]} == {"OffRankRuntime"}
    assert {row[4] for row in r1["idle"]} == {"BlockRuntime"}
    idle = [row for row in strip[0] if row[0] == "idle"]
    assert all(row[1] == [True] and row[2] == 0 for row in idle)
    rounds = [row for row in strip[0] if row[0] == "round"]
    assert rounds[0][1] == [False] and rounds[-1][1] == [True]
    steps = [row[2] for row in rounds]
    assert steps[-1] == steps[-2] > 0      # idle again: no more rounds


def test_launcher_autostep_on_two_ranks_gives_the_client_driven_losses(
        pair):
    for r in pair:
        client, auto = r["launcher"]["client"], r["launcher"]["auto"]
        assert client["losses"] == auto["losses"] and len(
            auto["losses"]) == 4
        assert client["daemon"] == "ClusterDaemon"
        assert auto["daemon"] == "ServiceDaemon"
        assert auto["log"]["log_entries"] > 0
        assert auto["log"]["diverged"] is None
        assert auto["start_step"] == 0 and auto["checkpoints"][-1] == 4
    assert (pair[0]["launcher"]["auto"]["losses"]
            == pair[1]["launcher"]["auto"]["losses"])


def test_a_follower_that_diverges_raises_at_the_next_entry(pair):
    msg = pair[1]["tripwire"]
    assert msg is not None and "entry 0 (register(" in msg
    assert "rank 1 diverged from rank 0" in msg
    assert pair[1]["stop"] == "stop"


# =========================================================== in process

@pytest.fixture
def one_rank(tmp_path):
    """A gloo world of one rank in this process, destroyed after."""
    import torch.distributed as dist
    from repro_torch import device as D
    D.init_distributed("cpu", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1, timeout_s=60)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_the_leader_at_world_one_logs_every_mutation(one_rank, tmp_path):
    """At world 1 the leader's log passes every command, tick and round
    through the control group; a command whose arguments do not pickle
    raises on the leader, naming it, before anything is sent."""
    from repro_torch import device as D
    from repro_torch.core.runtime import SimJobSpec
    from repro_torch.core.service import ServiceDaemon
    from repro_torch.core.topology import Topology
    before = dict(D.CONTROL)
    with ServiceDaemon(Topology(n_pods=1, pod_x=2, pod_y=1),
                       devices=["cpu"] * 2, ckpt_root=str(tmp_path / "c"),
                       background=True, tick_interval_s=0.01) as d:
        app, grant = d.submit("alice", "sim", 1, job=SimJobSpec(),
                              duration_s=0.2)
        assert grant is not None
        deadline = time.time() + 30
        while d.registry.get(app).state.value != "expired":
            assert time.time() < deadline, "no expiry on the tick"
            time.sleep(0.01)
        sent = d.log_entries
        with pytest.raises(TypeError, match="'register' command"):
            d.register("alice", lambda: 0, 1)
        assert d.log_entries == sent
    stats = d.log_stats()
    assert stats["log_entries"] > 2 and stats["diverged"] is None
    assert D.CONTROL["entries"] - before["entries"] == stats["log_entries"]
    with pytest.raises(RuntimeError, match="closed"):
        d.submit("alice", "after the stop", 1)


def test_the_tripwires_name_the_entry(one_rank, tmp_path):
    from repro_torch.core.service import Divergence, Entry, ServiceDaemon
    from repro_torch.core.topology import Topology
    d = ServiceDaemon(Topology(n_pods=1, pod_x=1, pod_y=1),
                      devices=["cpu"], ckpt_root=str(tmp_path / "c"))
    d._check(Entry(0, "tick", (), {"now": 1.0}, 1.0, d.tally, "ok"))
    with pytest.raises(Divergence, match=r"entry 0 \(tick\(now=1.0\)\)"):
        d._check(Entry(0, "tick", (), {"now": 1.0}, 1.0, d.tally + 1, "ok"))
    with pytest.raises(Divergence, match="'KeyError'"):
        d._check(Entry(0, "expire", ("app_0000",), {}, 1.0, d.tally,
                       "KeyError"))
    d.stop()


def test_a_service_daemon_needs_a_process_group():
    import torch.distributed as dist
    from repro_torch.core.service import ServiceDaemon
    from repro_torch.core.topology import Topology
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        ServiceDaemon(Topology(n_pods=1, pod_x=1, pod_y=1),
                      devices=["cpu"], ckpt_root="unused")


def test_chip_smoke_service_phase_on_cpu():
    """``chip_smoke.py``'s service phase at smoke size on the CPU (gloo,
    one rank) with the port's race detector installed: Alice's and the
    launcher's losses and grad norms train_hybrid's and train_f32's, Bob's
    tokens serve_paged's, bit for bit, the logs' entries counted and no
    tripwire, the group destroyed after."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from repro_torch.analysis import runtime_check
        runtime_check.install()
        import torch
        torch.set_num_threads(1)
        import chip_smoke as c
        paged = c.phase_serve_paged(device="cpu", smoke=True)
        train = c.phase_train_hybrid(device="cpu", smoke=True)
        f32 = c.phase_train_f32(device="cpu", smoke=True)
        out = c.phase_service(device="cpu", smoke=True, train=train,
                              paged=paged, f32=f32)
        assert out["backend"] == "gloo" and out["world_size"] == 1
        assert out["alice"]["losses"] == train["losses"][:2]
        assert out["launcher"]["losses"] == f32["losses"]
        assert out["bob"]["tokens"] == 12 * c.PAGED_NEW_TOKENS_SMOKE
        assert out["log"]["log_entries"] > 0
        assert out["launcher_log"]["log_entries"] > 0
        assert set(out["launches"].values()) == {{0}}
        import torch.distributed as dist
        assert not dist.is_initialized()
        assert runtime_check.violations() == [], runtime_check.violations()
        print("SERVICE_OK")
    """)
    env = dict(ENV, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=str(ROOT))
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "SERVICE_OK" in r.stdout
