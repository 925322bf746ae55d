"""The port's web gateway against the JAX package's, on the CPU.

* **Twins** of the reference's gateway tests (``tests/test_gateway.py``):
  each runs the reference test's own code with every name it takes from
  ``repro`` bound to the port's object (``twins`` of
  ``tests/test_torch_control.py``), a port ``gw`` fixture on
  ``["cpu"] * 8`` devices, and ``jax.devices()`` read as the host's one
  device (``HOST``) in the two tests that build their daemon inline.
* **Generate over the wire** (twins of ``tests/test_serve.py``'s three
  HTTP generate tests): a paged block of mistral_nemo_12b's smoke config
  in fp32, its params moved over from the reference's block of the same
  job; the tokens streamed by the port's gateway are the session's
  ``generated`` and, greedy, the reference gateway's on the same prompts.
* **A real train block over HTTP**: the explicit workflow (register,
  review, confirm, activate, run, ``/steps``, ``/download``) on
  deepseek_7b's smoke config, bit for bit a direct ``run_steps`` of the
  same job.
* **The tensor guard**: every bus event and every response body of the
  real-block tests encodes with ``json.dumps`` and no ``default=``, so no
  tensor reaches a client as the string ``"tensor(...)"``.
* The 501 for an arch of a family the port has not ported, a several-chip
  activation answered with its reason and the pump alive, and
  ``chip_smoke.py``'s gateway phase at smoke size with the port's race
  detector installed.

Tolerances: none.  Greedy tokens across the packages are compared
exactly (fp32 params, the train slice's parity config), everything
within the port bit for bit.
"""
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import textwrap
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_gateway as ref_gateway  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
from repro.core.daemon import ClusterDaemon as JDaemon  # noqa: E402
from repro.core.topology import Topology as JTopology  # noqa: E402
from repro.gateway import GatewayServer as JGatewayServer  # noqa: E402
from repro.gateway import ProfileStore as JProfileStore  # noqa: E402
from repro.gateway import UserProfile as JUserProfile  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.daemon import ClusterDaemon  # noqa: E402
from repro_torch.core.topology import Topology  # noqa: E402
from repro_torch.gateway import (GatewayServer, ProfileStore,  # noqa: E402
                                 UserProfile)
from repro_torch.gateway.handlers import parse_job  # noqa: E402
from test_torch_control import twins  # noqa: E402
from test_torch_kernels import _chip_smoke  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

ROOT = Path(__file__).resolve().parents[1]

#: ``chip_smoke.py``: its HTTP client and strict encoder serve the tests too
smoke = _chip_smoke()


# ================================================================ twins

@pytest.fixture
def gw(tmp_path):
    """The reference fixture's daemon and gateway, on the port: a
    background daemon on an 8-chip pod, one ``"cpu"`` per chip, two users
    with distinct profiles plus an admin."""
    topo = Topology(n_pods=1, pod_x=4, pod_y=2)
    daemon = ClusterDaemon(topo, devices=["cpu"] * topo.n_chips,
                           ckpt_root=str(tmp_path / "ckpt"),
                           background=True, tick_interval_s=0.01)
    profiles = ProfileStore([
        UserProfile("alice", "tok-alice", priority=0),
        UserProfile("bob", "tok-bob", priority=5, deadline_s=60.0),
        UserProfile("root", "tok-admin", admin=True),
    ])
    server = GatewayServer(daemon, profiles).start()
    yield server, daemon
    server.stop()
    daemon.stop()


#: ``jax`` in the twins' namespace: the two reference tests that build
#: their daemon inline take ``jax.devices()[0]`` for every chip, which on
#: the port is the host
HOST = types.SimpleNamespace(devices=lambda: ["cpu"])

TWIN_CASES = sorted(n for n in vars(ref_gateway) if n.startswith("test_"))


def test_twins_cover_the_reference_tests():
    assert len(TWIN_CASES) == 12


@pytest.mark.parametrize("name", TWIN_CASES)
def test_twin(name, request, tmp_path):
    g = twins(ref_gateway)
    g["jax"] = HOST
    fn = g[name]
    params = inspect.signature(fn).parameters
    kwargs = {}
    if "tmp_path" in params:
        kwargs["tmp_path"] = tmp_path
    if "gw" in params:
        kwargs["gw"] = request.getfixturevalue("gw")
    fn(**kwargs)


# ======================================================= the tensor guard

@pytest.fixture
def strict_json(monkeypatch):
    from repro_torch.gateway import handlers, server
    strict = smoke.StrictJSON()
    monkeypatch.setattr(server, "json", strict)
    monkeypatch.setattr(handlers, "json", strict)
    yield strict
    assert strict.failures == [], strict.failures
    assert strict.encoded > 0


def assert_strict_json(daemon, bodies):
    """Every event on the bus and every body a client received encodes
    with ``json.dumps`` and no ``default=``, and no string in them is a
    tensor written out by ``str``."""
    evs = daemon.events_since(0, limit=1 << 30)
    assert evs
    for obj in [e.to_dict() for e in evs] + list(bodies):
        text = json.dumps(obj)
        assert "tensor(" not in text, text[:300]


def test_tensor_guard_catches_a_tensor_the_encoders_would_hide(
        gw, strict_json):
    """The guard is not vacuous: a tensor in an event payload is a string
    under the reference encoders' ``default=str`` and an error under the
    strict one, over the wire and on the bus."""
    server, daemon = gw
    hidden = json.dumps({"x": torch.tensor(1.5)}, default=str)
    assert "tensor(1.5000)" in hidden
    client = smoke.HttpClient(server.url)
    _, a = client.req("POST", "/v1/submit", "tok-alice",
                      {"job_description": "guarded", "n_chips": 4,
                       "job": ref_gateway.SIM})
    daemon.bus.publish("session", app_id=a["app_id"], action="noted",
                       token=torch.tensor(2))
    with pytest.raises(TypeError):
        assert_strict_json(daemon, [])
    with pytest.raises((urllib.error.URLError, ConnectionError)):
        # the handler thread's encode fails: the connection closes
        # without a response
        client.req("GET", f"/v1/blocks/{a['app_id']}/events", "tok-alice")
    assert strict_json.failures
    strict_json.failures.clear()


# ================================================ generate over the wire

#: ``tests/test_serve.py``'s paged serve job (mistral_nemo_12b's smoke
#: config, 4 slots of page 4); both packages' configs read in fp32 here
SERVE_JOB = {"kind": "serve", "arch": "mistral_nemo_12b", "paged": True,
             "page_size": 4, "max_slots": 4, "seq_len": 32,
             "global_batch": 1}


@pytest.fixture
def fp32_smoke(monkeypatch):
    """Both gateways build their jobs from fp32 smoke configs (the lazy
    ``configs.get_smoke`` that ``parse_job`` calls), so greedy tokens are
    compared across the packages without bf16 rounding."""
    for mod in (jconfigs, configs):
        get = mod.get_smoke
        monkeypatch.setattr(
            mod, "get_smoke",
            lambda arch, get=get: dataclasses.replace(
                get(arch), param_dtype="float32"))


class Side:
    """One package's background daemon on a 2-chip pod (as
    ``tests/test_serve.py``'s ``make_daemon``) behind its gateway, for the
    generate twins.  The reference side keeps each paged block's params
    as it submits the block; the port's side installs them, in the same
    order, through ``interop`` before the block's first generate."""

    def __init__(self, port, root, params, **server_kw):
        if port:
            self.daemon = ClusterDaemon(
                Topology(n_pods=1, pod_x=2, pod_y=1), devices=["cpu"] * 2,
                ckpt_root=root, background=True, tick_interval_s=0.01)
            gateway = (GatewayServer, ProfileStore, UserProfile)
        else:
            self.daemon = JDaemon(
                JTopology(n_pods=1, pod_x=2, pod_y=1),
                devices=[jax.devices()[0]] * 2, ckpt_root=root,
                background=True, tick_interval_s=0.01)
            gateway = (JGatewayServer, JProfileStore, JUserProfile)
        server_cls, store, user = gateway
        self.server = server_cls(self.daemon, store(
            [user("alice", "tok-alice"), user("bob", "tok-bob")]),
            **server_kw).start()
        self.client = smoke.HttpClient(self.server.url)
        self.req, self.bodies = self.client.req, self.client.bodies
        self.port, self.params, self.n = port, params, 0

    def stream(self, path, token, body):
        return self.client.stream("POST", path, token, body)

    def submit_paged(self, token="tok-alice"):
        s, a = self.req("POST", "/v1/submit", token,
                        {"job_description": "serve", "n_chips": 1,
                         "job": SERVE_JOB})
        assert s == 201 and a["admitted"], a
        rt = self.daemon.runtime(a["app_id"])
        if self.port:
            with self.daemon._serial:
                rt.init_state(params=interop.params_from_numpy(
                    self.params[self.n], "cpu"))
        else:
            self.params.append(jax.tree.map(np.array, rt.state["params"]))
        self.n += 1
        return a["app_id"]

    def stop(self):
        self.server.stop()
        self.daemon.stop()


def on_both(tmp_path, scenario, **server_kw):
    """Run ``scenario(side)`` on the reference's gateway, then on the
    port's with the reference blocks' params; returns both results and the
    port's side (stopped)."""
    params, out = [], []
    for port in (False, True):
        side = Side(port, str(tmp_path / ("t" if port else "j")), params,
                    **server_kw)
        try:
            out.append(scenario(side))
        finally:
            side.stop()
    return out[0], out[1], side


def _sse_scenario(side):
    """``test_generate_sse_stream_over_the_wire``'s steps; returns the
    streamed tokens."""
    app = side.submit_paged()
    frames = side.stream(f"/v1/blocks/{app}/generate", "tok-alice",
                         {"prompt": [5, 6, 7], "max_new_tokens": 6})
    gen = [f for f in frames if f["event"] == "generate"]
    assert [f["data"]["index"] for f in gen] == list(range(6))
    assert gen[-1]["data"]["done"] is True
    acts = [f["data"]["action"] for f in frames if f["event"] == "session"]
    assert acts[0] == "submitted" and "admitted" in acts
    ids = [f["id"] for f in frames]
    assert ids == sorted(set(ids))
    # the streamed tokens are the session's actual output
    rt = side.daemon.runtime(app)
    sid = gen[0]["data"]["session"]
    tokens = [f["data"]["token"] for f in gen]
    assert tokens == rt.sessions.sessions[sid].generated
    side.req("POST", f"/v1/blocks/{app}/expire", "tok-alice", {})
    return tokens


def test_generate_sse_stream_over_the_wire(tmp_path, fp32_smoke,
                                           strict_json):
    """The quickstart path on a paged torch block: the token-by-token SSE
    stream ends at the final frame, its tokens are the session's
    ``generated`` and the reference gateway's, greedy, on the same
    params."""
    want, got, side = on_both(tmp_path, _sse_scenario)
    assert got == want and len(got) == 6
    assert_strict_json(side.daemon, side.bodies)


def _longpoll_scenario(side):
    """``test_generate_longpoll_validation_and_ownership``'s steps;
    returns the two long-polled completions."""
    app = side.submit_paged()
    gen = f"/v1/blocks/{app}/generate"
    s, out = side.req("POST", gen, "tok-alice",
                      {"prompt": [9, 9], "max_new_tokens": 4,
                       "stream": False})
    assert s == 200 and out["done"] and len(out["tokens"]) == 4
    # two concurrent sessions keep their streams apart
    s2, out2 = side.req("POST", gen, "tok-alice",
                        {"prompt": [1, 2, 3], "max_new_tokens": 4,
                         "stream": False})
    assert s2 == 200 and out2["session"] != out["session"]
    sessions = side.daemon.runtime(app).sessions.sessions
    for o in (out, out2):
        assert o["tokens"] == sessions[o["session"]].generated
    # malformed prompts never reach the scheduler
    for bad in [None, [], [1.5], [-1], [True], "abc"]:
        s, e = side.req("POST", gen, "tok-alice",
                        {"prompt": bad, "stream": False})
        assert s == 400, bad
    s, _ = side.req("POST", gen, "tok-alice",
                    {"prompt": [1], "max_new_tokens": 0, "stream": False})
    assert s == 400
    # ownership: bob cannot generate on alice's block
    s, _ = side.req("POST", gen, "tok-bob", {"prompt": [1],
                                             "stream": False})
    assert s == 403
    # a dense (non-paged) serve block has no generate surface -> 409
    s, dense = side.req("POST", "/v1/submit", "tok-bob",
                        {"job_description": "dense", "n_chips": 1,
                         "job": {"kind": "serve",
                                 "arch": "mistral_nemo_12b",
                                 "seq_len": 32, "global_batch": 1}})
    assert s == 201
    s, e = side.req("POST", f"/v1/blocks/{dense['app_id']}/generate",
                    "tok-bob", {"prompt": [1], "stream": False})
    assert s == 409 and "paged" in e["error"]
    for a, t in [(app, "tok-alice"), (dense["app_id"], "tok-bob")]:
        side.req("POST", f"/v1/blocks/{a}/expire", t, {})
    return [out["tokens"], out2["tokens"]]


def test_generate_longpoll_validation_and_ownership(tmp_path, fp32_smoke,
                                                    strict_json):
    want, got, side = on_both(tmp_path, _longpoll_scenario)
    assert got == want
    assert_strict_json(side.daemon, side.bodies)


def _storm_scenario(side):
    """``test_generate_storm_429_and_body_cap_413``'s steps; returns the
    completions the limiter let through."""
    app = side.submit_paged()                   # burst 1
    gen = f"/v1/blocks/{app}/generate"
    body = {"prompt": [1, 2], "max_new_tokens": 2, "stream": False}
    res = [side.req("POST", gen, "tok-alice", body) for _ in range(6)]
    codes = [s for s, _ in res]
    assert codes[:3] == [200, 200, 200], codes  # burst 2..4
    assert codes[3:] == [429, 429, 429], codes  # storm throttled
    s, e = side.req("POST", gen, "tok-alice", body)
    assert s == 429 and e["retry_after_s"] > 0
    # another user's bucket is untouched by alice's storm
    app_b = side.submit_paged("tok-bob")
    s, out_b = side.req("POST", f"/v1/blocks/{app_b}/generate", "tok-bob",
                        {"prompt": [3], "max_new_tokens": 2,
                         "stream": False})
    assert s == 200
    # oversized prompt body: refused by the cap before parsing (the
    # server may close the socket without reading the body)
    try:
        s, e = side.req("POST", f"/v1/blocks/{app_b}/generate", "tok-bob",
                        {"prompt": list(range(1000)), "stream": False})
        assert s == 413 and "cap" in e["error"]
    except (ConnectionError, urllib.error.URLError):
        pass
    assert side.req("GET", "/v1/ping")[0] == 200   # still serving
    return [o["tokens"] for _, o in res[:3]] + [out_b["tokens"]]


def test_generate_storm_429_and_body_cap_413(tmp_path, fp32_smoke,
                                             strict_json):
    """The generate endpoint sits behind the per-session token bucket (429
    on a storm) and the body cap (413), on the port as on the
    reference."""
    want, got, side = on_both(tmp_path, _storm_scenario,
                              rate_limit_rps=0.001, rate_limit_burst=4,
                              max_body_bytes=2048)
    assert got == want and all(len(t) == 2 for t in got)
    assert_strict_json(side.daemon, side.bodies)


# ============================================ a real train block over HTTP

TRAIN_JOB = {"kind": "train", "arch": "deepseek_7b", "seq_len": 16,
             "global_batch": 2}


def test_train_block_over_http_is_the_direct_run(gw, strict_json):
    """The paper's explicit workflow over the wire with a real torch train
    block (deepseek_7b's smoke config): register, admin review, confirm
    with the capability token, activate, run, ``/steps`` for 2 steps,
    ``/download``.  Its step count and its state after the 2 steps are
    those of a direct ``run_steps`` of the same job, bit for bit."""
    from test_torch_control import _bits, _same_bits
    server, daemon = gw
    client = smoke.HttpClient(server.url)
    req = client.req

    s, r = req("POST", "/v1/register", "tok-alice",
               {"job_description": "train over http", "n_chips": 1})
    assert s == 201 and r["state"] == "requested"
    app = r["app_id"]
    s, rv = req("POST", f"/v1/blocks/{app}/review", "tok-admin", {})
    assert s == 200 and rv["approved"]
    _, st = req("GET", f"/v1/blocks/{app}", "tok-alice")
    s, cf = req("POST", f"/v1/blocks/{app}/confirm", "tok-alice",
                {"token": st["token"]})
    assert s == 200 and cf["state"] == "confirmed"
    s, ac = req("POST", f"/v1/blocks/{app}/activate", "tok-alice",
                {"job": TRAIN_JOB})
    assert s == 200 and ac["state"] == "active"
    s, rn = req("POST", f"/v1/blocks/{app}/run", "tok-alice", {})
    assert s == 200 and rn["state"] == "running"
    s, stepped = req("POST", f"/v1/blocks/{app}/steps", "tok-alice",
                     {"rounds": 2})
    assert s == 200 and stepped["completed"] == 2 and stepped["steps"] == 2
    s, res = req("GET", f"/v1/blocks/{app}/download", "tok-alice")
    assert s == 200 and res["steps"] == 2
    s, cl = req("GET", "/v1/cluster", "tok-alice")
    assert s == 200
    with daemon._serial:
        got = _bits(daemon.runtime(app).state)
    s, ex = req("POST", f"/v1/blocks/{app}/expire", "tok-alice", {})
    assert s == 200 and ex["state"] == "expired"

    direct = ClusterDaemon(Topology(n_pods=1, pod_x=1, pod_y=1),
                           devices=["cpu"], ckpt_root=str(
                               Path(daemon.ctl.ckpt_root) / "direct"))
    a, _ = direct.submit("alice", "direct", 1, job=parse_job(TRAIN_JOB))
    direct.run_steps({a: 2})
    rt = direct.runtime(a)
    assert rt.step_count == res["steps"]
    assert _same_bits(got, _bits(rt.state))
    assert_strict_json(daemon, client.bodies)


# ======================================================= port departures

def test_unported_family_answers_501_naming_it(gw, monkeypatch):
    """``parse_job`` is the handler twin's one departure: an arch the
    reference accepts but whose family the port has not ported answers 501
    with the family's name, not the server's catch-all 500.  Every family
    is ported now, so an xlstm submit is accepted, and the refusal is
    shown with a stand-in entry in ``configs._NOT_PORTED`` (yi_34b marked
    as of a family not ported)."""
    from repro.gateway.handlers import parse_job as ref_parse_job
    server, daemon = gw
    req = smoke.HttpClient(server.url).req
    xlstm = {"kind": "serve", "arch": "xlstm_350m"}
    assert parse_job(xlstm).cfg == configs.get_smoke("xlstm_350m")
    assert ref_parse_job(xlstm).cfg.family == "xlstm"
    job = {"kind": "serve", "arch": "yi_34b"}
    assert ref_parse_job(job).cfg.family == "dense"
    monkeypatch.setitem(configs._NOT_PORTED, "yi_34b", "stand-in")
    s, e = req("POST", "/v1/submit", "tok-alice",
               {"job_description": "stand-in", "n_chips": 1, "job": job})
    assert s == 501 and "stand-in family" in e["error"], (s, e)
    assert "yi_34b" in e["error"]
    assert daemon.list_apps() == []            # refused before submitting
    monkeypatch.delitem(configs._NOT_PORTED, "yi_34b")
    s, b = req("POST", "/v1/submit", "tok-alice",
               {"job_description": "xlstm", "n_chips": 1, "job": xlstm})
    assert s == 201 and b["admitted"] and b["state"] == "running", b
    assert set(daemon.runtime(b["app_id"]).cache) == {"mlstm", "slstm"}
    s, e = req("POST", "/v1/submit", "tok-alice",
               {"job_description": "typo", "n_chips": 1,
                "job": {"kind": "serve", "arch": "no_such_arch"}})
    assert s == 400 and "unknown arch" in e["error"]


def test_vlm_serve_and_encoder_train_jobs_are_admitted(gw):
    """The families the port now has: a smoke pixtral_12b serve job and a
    smoke hubert_xlarge train job submitted over HTTP are admitted and
    running, as the reference's gateway parses them, and the train block
    takes a step over the wire."""
    from repro.gateway.handlers import parse_job as ref_parse_job
    server, daemon = gw
    req = smoke.HttpClient(server.url).req
    jobs = {"pixtral_12b": {"kind": "serve", "arch": "pixtral_12b",
                            "seq_len": 40, "global_batch": 2},
            "hubert_xlarge": {"kind": "train", "arch": "hubert_xlarge",
                              "seq_len": 16, "global_batch": 2}}
    apps = {}
    for arch, job in jobs.items():
        assert parse_job(job).cfg == configs.get_smoke(arch)
        assert parse_job(job).cfg.family == ref_parse_job(job).cfg.family
        s, b = req("POST", "/v1/submit", "tok-alice",
                   {"job_description": arch, "n_chips": 1, "job": job})
        assert s == 201 and b["admitted"] and b["state"] == "running", b
        apps[arch] = b["app_id"]
    assert daemon.runtime(apps["pixtral_12b"]).cache is not None
    s, r = req("POST", f"/v1/blocks/{apps['hubert_xlarge']}/steps",
               "tok-alice", {"rounds": 1})
    assert s == 200 and r["completed"] == 1, r
    assert daemon.runtime(apps["hubert_xlarge"]).step_count == 1


def test_several_chip_activation_answers_with_its_reason(tmp_path):
    """A real block granted two chips on two distinct devices cannot
    activate in a process with no process group (a block of several
    devices runs one rank a device): the submit answers 500 with the
    runtime's reason, the pump thread lives on, and the block's chips
    come back when it expires."""
    topo = Topology(n_pods=1, pod_x=2, pod_y=1)
    daemon = ClusterDaemon(topo, devices=["cpu", "meta"],
                           ckpt_root=str(tmp_path / "ckpt"),
                           background=True, tick_interval_s=0.01)
    server = GatewayServer(daemon, ProfileStore(
        [UserProfile("alice", "tok-alice")])).start()
    req = smoke.HttpClient(server.url).req
    try:
        s, e = req("POST", "/v1/submit", "tok-alice",
                   {"job_description": "two devices", "n_chips": 2,
                    "job": TRAIN_JOB})
        assert s == 500 and "needs a process group" in e["error"], (s, e)
        assert daemon.running
        assert req("GET", "/v1/ping")[0] == 200
        (blk,) = daemon.list_apps()
        s, ex = req("POST", f"/v1/blocks/{blk['app_id']}/expire",
                    "tok-alice", {})
        assert s == 200 and ex["state"] == "expired"
        s, a = req("POST", "/v1/submit", "tok-alice",
                   {"job_description": "sim", "n_chips": 2,
                    "job": ref_gateway.SIM})
        assert s == 201 and a["admitted"] and a["state"] == "running"
    finally:
        server.stop()
        daemon.stop()


# ====================================================== the gateway phase

def test_chip_smoke_gateway_phase_on_cpu_race_checked():
    """``chip_smoke.py``'s gateway phase at smoke size on the CPU, in a
    process with the port's race detector installed: Alice's explicit
    workflow and Bob's 12 concurrent generate requests over HTTP across
    an admin's preemption, each session's tokens serve_paged's, root's
    feed the bus's, every body encoded strictly, and no violation
    recorded."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        from repro_torch.analysis import runtime_check
        runtime_check.install()
        import torch
        torch.set_num_threads(1)
        import chip_smoke as c
        paged = c.phase_serve_paged(device="cpu", smoke=True)
        out = c.phase_gateway(device="cpu", smoke=True, paged=paged)
        bob = out["bob"]
        assert bob["tokens"] == 12 * c.PAGED_NEW_TOKENS_SMOKE
        assert bob["sse_sessions"] == 11
        assert bob["rounds"] >= paged["decode_rounds"]
        assert out["admin"]["compile_after_preempt"]
        assert out["alice"]["steps"] == 2 and out["alice"]["mfu"] > 0
        assert set(out["launches"].values()) == {{0}}
        assert out["strict_encodes"] > 0
        assert runtime_check.violations() == [], runtime_check.violations()
        print("GATEWAY_OK")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, env=env, cwd=str(ROOT))
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr}"
    assert "GATEWAY_OK" in r.stdout
