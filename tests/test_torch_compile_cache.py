"""The port's compiled-step cache and captured steps, on the CPU.

* ``repro_torch.train.compile_cache`` against the reference's unit tests
  (``tests/test_train.py``): ``freeze``, ``mesh_fingerprint(None)``,
  hits, misses and their events on the copied ``EventBus``; the port's
  keys freeze the same configs to the same tuples as the reference's;
* the port's counterpart of ``test_resume_is_a_compile_cache_hit``
  (``tests/test_preemption.py``), through ``BlockRuntime.suspend()`` /
  ``resume()`` (the port has no controller yet): a train block, a dense
  serve block and a paged serve block resume with ``misses`` unchanged;
* ``CapturedStep`` with ``torch.cuda.CUDAGraph`` stood in for
  (``StandInGraph``: a capture runs the step's Python once and leaves its
  inputs as they were, a replay runs the step again on the captured
  arguments without moving the launch counters), the way
  ``test_ssd_scan_autograd_function_wiring_on_cpu`` stands in for the
  CUDA wrappers: inputs copied into the graph's buffers, counter changes
  added per replay, outputs copied out, a new bound tensor captured
  again, ``release()`` dropping every buffer; the dense (both families)
  and paged decode through captured steps giving an eager block's tokens
  and cache bit for bit; ``suspend()`` releasing the graphs;
* the eager route on the CPU, counted; a sampling job's decode step
  captured with its generator, drawing what an eager block draws, and
  the sampled ``pick`` drawing what ``torch.multinomial`` draws.
"""
import gc
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro.train import compile_cache as jcc  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.core.block import BlockGrant  # noqa: E402
from repro_torch.core.events import EventBus  # noqa: E402
from repro_torch.core.runtime import BlockRuntime, JobSpec  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import rmsnorm  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.serve.serve_step import pick  # noqa: E402
from repro_torch.train import compile_cache as cc  # noqa: E402
from repro_torch.train import optimizer as opt_lib  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

PAGED = dict(page_size=4, n_pages=6, max_slots=2, max_seq_len=32)


def grant():
    return BlockGrant.new([(0, 0, 0)], (1, 1), 60.0)


def smoke(arch):
    return configs.get_smoke(arch).replace(param_dtype="float32")


# ---------------------------------------------------- the reference's tests

def test_compile_cache_freeze_is_hashable_and_order_insensitive():
    cfg = opt_lib.OptConfig()
    k = cc.freeze(cfg)
    hash(k)                                         # usable as a dict key
    assert k[0] == "OptConfig"
    assert cc.freeze({"b": 2, "a": [1, {2}]}) == \
        cc.freeze({"a": (1, frozenset({2})), "b": 2})
    assert cc.mesh_fingerprint(None) == ("default",)
    # the port's one-device blocks key on their device instead
    assert cc.device_fingerprint("cpu") == ("cpu", None)
    assert cc.device_fingerprint(torch.device("cuda", 1)) == ("cuda", 1)
    assert cc.device_fingerprint("cuda:0") != cc.device_fingerprint("cuda:1")


def test_compile_cache_hit_miss_and_events():
    cache = cc.CompileCache()
    bus = EventBus()
    cache.set_bus(bus)
    builds = []

    def builder():
        builds.append(1)
        return "artifact"

    assert cache.get(("k", 1), builder, label="unit") == "artifact"
    assert cache.get(("k", 1), builder, label="unit") == "artifact"
    assert cache.get(("k", 2), builder) == "artifact"
    assert builds == [1, 1]                         # second call was a hit
    assert cache.stats() == {"hits": 1, "misses": 2, "entries": 2}
    actions = [e.payload["action"]
               for e in bus.events_since(kinds={"compile"})]
    assert actions == ["miss", "hit", "miss"]
    cache.clear()
    assert cache.stats() == {"hits": 0, "misses": 0, "entries": 0}


@pytest.mark.parametrize("arch", ["deepseek_7b", "zamba2_2p7b"])
def test_keys_freeze_configs_as_the_reference_does(arch):
    """The port's configs are the reference's copied, so a key part
    frozen by either package is the same tuple."""
    shape = dict(seq_len=16, global_batch=2)
    assert cc.freeze(configs.get_smoke(arch)) == \
        jcc.freeze(jconfigs.get_smoke(arch))
    assert cc.freeze(ShapeConfig("t", "train", **shape)) == \
        jcc.freeze(JShape("t", "train", **shape))
    assert cc.freeze(opt_lib.OptConfig(state_bits=8)) == \
        jcc.freeze(jopt.OptConfig(state_bits=8))


# ------------------------------------------------------ a hit after resume

def _job(kind, ns):
    if kind == "train":
        return JobSpec(smoke("deepseek_7b"),
                       ShapeConfig("t", "train", seq_len=16, global_batch=2),
                       kind="train", ckpt_namespace=ns,
                       opt=opt_lib.OptConfig(warmup_steps=1, total_steps=8))
    if kind == "paged":
        return JobSpec(smoke("deepseek_7b"),
                       ShapeConfig("s", "serve", seq_len=32, global_batch=1),
                       kind="serve", paged=True, ckpt_namespace=ns, **PAGED)
    return JobSpec(smoke("zamba2_2p7b" if kind == "hybrid" else
                         "deepseek_7b"),
                   ShapeConfig("s", "serve", seq_len=16, global_batch=2),
                   kind="serve", ckpt_namespace=ns)


def _prompt(cfg, batch=2):
    return pipeline.synthetic_batch(cfg, ShapeConfig("p", "prefill", 8,
                                                     batch),
                                    step=0, seed=3)["tokens"]


def _start(rt, kind):
    """Prefill a dense block or start paged sessions."""
    if kind == "paged":
        for s in (1, 5, 9):
            rt.start_session([s, s + 1, s + 2], max_new_tokens=6)
    elif kind != "train":
        rt.prefill({"tokens": _prompt(rt.job.cfg)})


def _advance(rt, kind, n):
    out = []
    for _ in range(n):
        if kind == "paged":
            out.append([(e["session"], e["token"]) for e in rt.feed()
                        if e["event"] == "token"])
        else:
            m = rt.step()
            out.append(m["loss"] if kind == "train" else rt.token.clone())
    return out


@pytest.mark.parametrize("kind", ["train", "dense", "paged"])
def test_resume_is_a_compile_cache_hit(kind, tmp_path):
    """Resuming on the same device builds nothing: the rebuilt runtime's
    steps come out of ``GLOBAL`` (the first attach was the only miss for
    each signature), the hits are announced on the bus, and the resumed
    block still steps."""
    bus = EventBus()
    cc.GLOBAL.clear()                       # process-wide: isolate the test
    cc.GLOBAL.set_bus(bus)
    try:
        g1, g2 = grant(), grant()
        rt = BlockRuntime(g1, _job(kind, "c"), devices=["cpu"],
                          ckpt_root=str(tmp_path))
        rt.init_state()
        _start(rt, kind)
        _advance(rt, kind, 2)
        first = cc.GLOBAL.stats()
        assert first["misses"] >= 1 and first["hits"] == 0
        rt.suspend()
        assert rt.resume(g2, ["cpu"]) == 2
        after = cc.GLOBAL.stats()
        assert after["misses"] == first["misses"], "resume rebuilt a step"
        assert after["hits"] >= 1
        _advance(rt, kind, 1)               # the reused step still steps
        assert cc.GLOBAL.stats()["misses"] == first["misses"]
        evs = bus.events_since(kinds={"compile"})
        actions = [e.payload["action"] for e in evs]
        assert actions.count("miss") == after["misses"]
        assert actions.count("hit") == after["hits"]
        assert {e.block_id for e in evs} <= {g1.block_id, g2.block_id,
                                             None}
    finally:
        cc.GLOBAL.set_bus(None)


# --------------------------------------------------- a stand-in CUDA graph

class StandInGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU.  A capture runs
    the step's Python once, as a real capture does, and puts every input
    tensor back as it found it (a real capture runs no kernel); a replay
    runs the step again on the captured arguments with the launch
    counters left where they were (a real replay runs no Python) and
    writes its results into the captured outputs."""

    def __init__(self, fn, args):
        self.fn, self.args, self.resets = fn, args, 0
        inputs = [t for t in pytree.tree_leaves(args)
                  if isinstance(t, torch.Tensor)]
        saved = [t.clone() for t in inputs]
        self.out = fn(*args)
        for t, s in zip(inputs, saved):
            t.copy_(s)

    def replay(self):
        counts = cc.counters()
        new = self.fn(*self.args)
        cc.set_counters(counts)
        for old, got in zip(pytree.tree_leaves(self.out),
                            pytree.tree_leaves(new)):
            if isinstance(old, torch.Tensor) and old is not got:
                old.copy_(got)

    def reset(self):
        self.resets += 1
        self.args = self.out = None


class StandInBackend:
    def __init__(self, device):
        self.device = device
        self.warmups, self.graphs, self.generators = [], [], []

    def warmup(self, fn, args):
        self.warmups.append([id(a) for a in args])
        fn(*args)

    def capture(self, fn, args, generators=()):
        self.generators.append(list(generators))
        graph = StandInGraph(fn, args)
        self.graphs.append(graph)
        return graph, graph.out, 0


def stand_in_graphs(monkeypatch):
    """From here on every CapturedStep captures, on stand-in graphs;
    returns the list their backends are appended to."""
    backends = []

    def backend(device):
        backends.append(StandInBackend(device))
        return backends[-1]

    monkeypatch.setattr(cc, "_on_card", lambda leaves: True)
    monkeypatch.setattr(cc, "_backend", backend)
    return backends


@pytest.fixture
def stand_in(monkeypatch):
    return stand_in_graphs(monkeypatch)


def toy_step(w, x, state, n):
    """A step with the runtime's argument kinds: read-only weights, a
    copied input, a state updated in place (donated) and a position
    scalar the caller refills.  Its Python "launches" two RMSNorms."""
    rmsnorm.LAUNCHES += 2
    y = torch.tanh(x @ w + state.sum(0) * 0.1 + n.float())
    state.mul_(0.5).add_(y)
    return (y * 2)[:, :1], state


def test_captured_step_wiring_with_a_stand_in_graph(stand_in,
                                                    monkeypatch):
    """Three calls of a captured toy step against the step run eagerly
    on the same inputs: equal outputs and state, each new input copied
    into the graph's buffer, each call 2 launches on the counter (the
    warm-up's and the capture's taken back), the warm-up on a copy of
    the donated state; then a new state tensor captured again, and
    ``release()`` dropping every buffer."""
    monkeypatch.setattr(rmsnorm, "LAUNCHES", 0)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    state = torch.zeros((3, 4))
    n = torch.zeros((), dtype=torch.int32)
    ref_state = state.clone()
    step = cc.CapturedStep(toy_step, static=(0, 2, 3), donate=(2,))
    for i in range(3):
        x = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
        n.fill_(i)
        want, _ = toy_step(w, x.clone(), ref_state, n.clone())
        before = rmsnorm.LAUNCHES
        got, out_state = step(w, x, state, n)
        assert rmsnorm.LAUNCHES - before == 2
        assert torch.equal(got, want) and torch.equal(state, ref_state)
        assert out_state is state                   # bound: itself
        (_, buf), = step._inputs                    # x's graph buffer
        assert buf is not x and torch.equal(buf, x)
        graph = stand_in[0].graphs[0]
        assert got is not graph.out[0]              # copied out
    assert (step.captures, step.replays, step.eager_calls) == (1, 3, 0)
    assert stand_in[0].warmups == [[id(w), stand_in[0].warmups[0][1],
                                    stand_in[0].warmups[0][2], id(n)]]
    assert stand_in[0].warmups[0][2] != id(state)   # a copy of the state
    assert step.stats()["captures"] == 1

    # a new state tensor is another graph: released and captured again
    state2 = state.clone()
    got, out_state = step(w, x, state2, n)
    assert out_state is state2 and step.captures == 2
    assert graph.resets == 1
    refs = [weakref.ref(t) for t in (step._inputs[0][1], state2)]
    step.release()
    assert step._graph is None and step._inputs == [] and step._bound == []
    assert stand_in[0].graphs[1].resets == 1
    del state2, out_state, got
    stand_in.clear()
    gc.collect()
    assert all(r() is None for r in refs)


def append_step(w, x, cache, state, n):
    """A decode-like toy step: a row of ``cache`` written at ``n`` from
    the step's other inputs, then read whole (the attention's K/V), and
    a recurrent ``state`` read before it is written."""
    y = torch.tanh(x @ w + state)
    cache.index_copy_(0, n.reshape(1).long(), y[:1])
    state.add_(cache.sum(0, keepdim=True) * 0.1)
    return y[:, :1] + cache.sum(), cache, state


def test_warm_inplace_writes_append_only_leaves_in_place(stand_in):
    """``warm_inplace`` names the donated leaves the warm-up writes in
    place (no copy of a long cache while a step is captured); the
    recurrent state is still warmed on a copy, and three calls give the
    eager step's outputs, cache and state bit for bit."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    cache, state = torch.zeros((5, 4)), torch.zeros((1, 4))
    n = torch.zeros((), dtype=torch.int32)
    ref = (cache.clone(), state.clone())
    step = cc.CapturedStep(append_step, static=(0, 2, 3, 4), donate=(2, 3),
                           warm_inplace=lambda t: t is cache)
    for i in range(3):
        x = torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
        n.fill_(i)
        want, _, _ = append_step(w, x.clone(), *ref, n.clone())
        got, c, st = step(w, x, cache, state, n)
        assert c is cache and st is state
        assert torch.equal(got, want) and torch.equal(cache, ref[0])
        assert torch.equal(state, ref[1])
    ids = stand_in[0].warmups[0]
    assert ids[2] == id(cache) and ids[3] != id(state)
    assert (step.captures, step.replays) == (1, 3)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(pytree.tree_leaves(a),
                                                   pytree.tree_leaves(b)))


@pytest.mark.parametrize("kind", ["dense", "hybrid", "paged"])
def test_captured_decode_matches_eager_with_a_stand_in_graph(kind,
                                                              monkeypatch):
    """The runtime's decode through captured steps gives an eager
    block's tokens and cache (or pool) bit for bit over 6 steps: each
    replay reads the position the runtime refilled (a Python int would
    have been baked into the graph), the paged round its three input
    buffers.  One capture, a replay a step, no eager step."""
    eager = BlockRuntime(grant(), _job(kind, "e"), devices=["cpu"])
    eager.init_state()
    _start(eager, kind)
    want = _advance(eager, kind, 6)
    stand_in_graphs(monkeypatch)
    monkeypatch.setattr(cc, "EAGER_CALLS", 0)
    rt = BlockRuntime(grant(), _job(kind, "g"), devices=["cpu"])
    rt.init_state()
    _start(rt, kind)
    got = _advance(rt, kind, 6)
    graph = rt.decode_graph
    assert (graph.captures, graph.replays, graph.eager_calls) == (1, 6, 0)
    assert cc.EAGER_CALLS == 0
    if kind == "paged":
        assert got == want
        assert _same(rt.sessions.pool, eager.sessions.pool)
    else:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert _same(rt.cache, eager.cache) and rt.cache_len == 8 + 6
        assert len(set(t.data_ptr() for t in got)) == 6   # the caller's


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_suspend_releases_the_graphs(kind, stand_in, tmp_path):
    """With graphs in play, ``suspend()`` leaves no reference to the
    block's tensors or the graphs' buffers (with the garbage collector
    off), and the resumed block captures again at its first step."""
    rt = BlockRuntime(grant(), _job(kind, "r"), devices=["cpu"],
                      ckpt_root=str(tmp_path))
    rt.init_state()
    _start(rt, kind)
    _advance(rt, kind, 2)
    graph = rt.decode_graph
    assert graph.captures == 1
    held = [weakref.ref(t) for t in graph._bound + [b for _, b in
                                                    graph._inputs]]
    gc.collect()
    gc.disable()
    try:
        rt.suspend()
        alive = sum(r() is not None for r in held)
    finally:
        gc.enable()
    assert alive == 0 and len(held) > 5
    assert graph._graph is None and stand_in[0].graphs[0].resets == 1
    rt.resume(grant(), ["cpu"])
    _advance(rt, kind, 1)
    assert rt.decode_graph is not graph
    assert (rt.decode_graph.captures, rt.decode_graph.replays) == (1, 1)


def test_restore_releases_the_graph_and_replays_go_on(stand_in, tmp_path):
    """A live ``restore()`` replaces the cache the graph bound: the graph
    is released and the next step captures again, and the steps after the
    restore repeat those after the save bit for bit."""
    rt = BlockRuntime(grant(), _job("dense", "l"), devices=["cpu"],
                      ckpt_root=str(tmp_path))
    rt.init_state()
    _start(rt, "dense")
    _advance(rt, "dense", 2)
    rt.save(async_=False)
    want = _advance(rt, "dense", 3)
    graph = rt.decode_graph
    assert rt.restore() == 2 and graph._graph is None
    got = _advance(rt, "dense", 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (graph.captures, graph.replays) == (2, 8)


def test_cpu_steps_run_eagerly(monkeypatch):
    """On the CPU a step runs eagerly, its launches counted as it makes
    them, and the call is counted."""
    monkeypatch.setattr(cc, "EAGER_CALLS", 0)
    monkeypatch.setattr(rmsnorm, "LAUNCHES", 0)
    step = cc.CapturedStep(toy_step, static=(0, 2, 3), donate=(2,))
    for _ in range(2):
        step(torch.eye(4), torch.ones((3, 4)), torch.zeros((3, 4)),
             torch.zeros((), dtype=torch.int32))
    assert (step.captures, step.replays, step.eager_calls) == (0, 0, 2)
    assert cc.EAGER_CALLS == 2 and rmsnorm.LAUNCHES == 4
    step.capture = False          # a check's eager reference, anywhere
    stand_in_graphs(monkeypatch)
    step(torch.eye(4), torch.ones((3, 4)), torch.zeros((3, 4)),
         torch.zeros((), dtype=torch.int32))
    assert (step.captures, step.eager_calls, cc.EAGER_CALLS) == (0, 3, 3)


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_sampled_decode_captures_with_its_generator(kind, monkeypatch):
    """A sampling job's decode step captures too, its generator an
    argument: the warm-up's and the capture's draws are put back, so the
    replays draw what an eager block from the same seed draws, token for
    token (the paged plane's admissions draw eagerly in between)."""
    def run():
        job = _job(kind, "s")
        job.decode_sample = True
        rt = BlockRuntime(grant(), job, devices=["cpu"])
        rt.init_state()
        _start(rt, kind)
        return rt, _advance(rt, kind, 5)

    _, want = run()
    stand_in_graphs(monkeypatch)
    rt, got = run()
    graph = rt.decode_graph
    assert (graph.captures, graph.replays, graph.eager_calls) == (1, 5, 0)
    if kind == "paged":
        assert got == want
    else:
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    gens = [a for a in graph._backend.graphs[0].args
            if isinstance(a, torch.Generator)]
    assert len(gens) == 1 and graph._backend.generators == [gens]


@pytest.mark.parametrize("seed", range(4))
def test_sampled_pick_draws_what_multinomial_draws(seed):
    """``pick(sample=True)`` writes out ``torch.multinomial``'s one-sample
    path without its host-side checks (which a capture refuses): the
    same tokens from the same generator, which ends in the same state."""
    logits = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (4, 97)).astype(np.float32) * 3)
    g1 = torch.Generator().manual_seed(seed)
    g2 = torch.Generator().manual_seed(seed)
    probs = torch.softmax(logits / 0.7, dim=-1)
    want = torch.multinomial(probs, 1, generator=g1)[:, 0].to(torch.int32)
    got = pick(logits, sample=True, gen=g2, temperature=0.7)
    assert torch.equal(got, want)
    assert torch.equal(g1.get_state(), g2.get_state())
