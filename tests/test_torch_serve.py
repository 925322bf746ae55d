"""The port's serve data plane against the JAX package's, on the fp32 tiny
config of tests/test_serve.py with the same params: greedy token streams
(and the whole emission stream) of ``DecodeScheduler``, the dense and
paged ``BlockRuntime`` surfaces, and the launcher.  The JAX runs are the
reference; the cases follow tests/test_serve.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.block import BlockGrant as JGrant  # noqa: E402
from repro.core.runtime import BlockRuntime as JRuntime  # noqa: E402
from repro.core.runtime import JobSpec as JJob  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import AttentionConfig as JAttn  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.serve.decode_scheduler import DecodeScheduler as JScheduler  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.block import BlockGrant  # noqa: E402
from repro_torch.core.runtime import BlockRuntime, JobSpec  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.config import (AttentionConfig, ModelConfig,  # noqa: E402
                                       ShapeConfig)
from repro_torch.serve.decode_scheduler import DecodeScheduler  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

TINY = dict(name="serve_t", family="dense", n_layers=2, d_model=32,
            vocab_size=64, d_ff=64, param_dtype="float32")


@pytest.fixture(scope="module")
def setup():
    jcfg = JModelConfig(**TINY, attention=JAttn(n_heads=4, n_kv_heads=2,
                                                head_dim=8))
    cfg = ModelConfig(**TINY, attention=AttentionConfig(n_heads=4,
                                                        n_kv_heads=2,
                                                        head_dim=8))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, cfg, jp, tp


def drain(sch, cap=500):
    ems = []
    for _ in range(cap):
        if not sch.has_work:
            return ems
        ems.extend(sch.step(now=0.0))
    raise AssertionError("scheduler did not drain")


def pair(setup, **geom):
    """The JAX scheduler and the port's, same params and geometry."""
    jcfg, cfg, jp, tp = setup
    return (JScheduler(jcfg, jp, **geom),
            DecodeScheduler(cfg, tp, device="cpu", **geom))


def run_both(setup, prompts, max_new, **geom):
    """Submit the same prompts to both and drain; the emission streams
    (every token, admission, eviction and finish, in order) must agree."""
    js, ts = pair(setup, **geom)
    sids = []
    for p in prompts:
        sids.append(js.submit(p, max_new_tokens=max_new))
        assert ts.submit(p, max_new_tokens=max_new) == sids[-1]
    want, got = drain(js), drain(ts)
    assert got == want
    for sid in sids:
        assert ts.sessions[sid].generated == js.sessions[sid].generated
        assert ts.sessions[sid].state == "done"
    return js, ts, sids


# ================================================= scheduler semantics

def test_every_page_alignment_matches_jax(setup):
    """Prompts of every page-alignment flavour, including the admission
    prefill with ``cache_len=0`` (a 0 must mean "empty cache")."""
    run_both(setup, [[9], [3, 1, 4], [3, 1, 4, 1], [3, 1, 4, 1, 5]], 10,
             page_size=4, n_pages=0, max_slots=4, max_seq_len=32)


def test_page_boundary_growth_matches_jax(setup):
    jcfg, cfg, jp, tp = setup
    js, ts = pair(setup, page_size=4, n_pages=0, max_slots=1, max_seq_len=16)
    sid = ts.submit([3, 1, 4], max_new_tokens=9)
    js.submit([3, 1, 4], max_new_tokens=9)
    ts.step()
    assert len(ts.sessions[sid].pages) == 1
    peak = 1
    while ts.has_work:
        ts.step()
        peak = max(peak, len(ts.sessions[sid].pages))
    assert peak == 3                          # grown page by page, on demand
    assert ts.sessions[sid].pages == []       # reclaimed on finish
    drain(js)
    assert ts.sessions[sid].generated == js.sessions[sid].generated


def test_full_pool_refusal_then_progress_matches_jax(setup):
    geom = dict(page_size=4, n_pages=4, max_slots=2, max_seq_len=12)
    js, ts = pair(setup, **geom)
    for s in (js, ts):
        s.submit([1, 2, 3, 4, 5], max_new_tokens=6)
        s.submit([6, 7, 8, 9, 10], max_new_tokens=6)
    assert ts.step(now=0.0) == js.step(now=0.0)
    assert ts.sessions["g000000"].state == "running"
    assert ts.sessions["g000001"].state == "queued"   # not half-admitted
    assert ts.pages.available == 1
    assert drain(ts) == drain(js)
    assert ts.sessions["g000001"].generated == \
        js.sessions["g000001"].generated
    assert ts.pages.available == 3


def test_eviction_and_requeue_match_jax(setup):
    _, ts, _ = run_both(setup, [[s, s + 1, s + 2] for s in (1, 4, 7)], 12,
                        page_size=4, n_pages=6, max_slots=3, max_seq_len=32)
    assert ts.evictions > 0                   # the pressure actually hit


def test_idle_slots_do_not_contaminate(setup):
    jcfg, cfg, jp, tp = setup
    solo = DecodeScheduler(cfg, tp, page_size=4, max_slots=1, max_seq_len=16,
                           device="cpu")
    wide = DecodeScheduler(cfg, tp, page_size=4, max_slots=8, max_seq_len=16,
                           device="cpu")
    jsolo = JScheduler(jcfg, jp, page_size=4, max_slots=1, max_seq_len=16)
    sids = [s.submit([5, 6, 7], max_new_tokens=8)
            for s in (solo, wide, jsolo)]
    for s in (solo, wide, jsolo):
        drain(s)
    assert solo.sessions[sids[0]].generated == \
        wide.sessions[sids[1]].generated == jsolo.sessions[sids[2]].generated


def test_submit_validation_and_eos(setup):
    jcfg, cfg, jp, tp = setup
    js, ts = pair(setup, page_size=4, max_slots=2, max_seq_len=8)
    for bad in ([], [1] * 8):
        with pytest.raises(ValueError):
            ts.submit(bad, max_new_tokens=2)
    with pytest.raises(ValueError):
        ts.submit([1], max_new_tokens=0)
    sid = ts.submit([1, 2], max_new_tokens=6)
    with pytest.raises(ValueError):
        ts.submit([3], sid=sid)               # duplicate id
    js.submit([1, 2], max_new_tokens=6)
    drain(js)
    first = js.sessions[sid].generated[0]
    eos = ts.submit([1, 2], max_new_tokens=6, eos_id=first)
    drain(ts)
    assert ts.sessions[eos].generated == [first]
    assert ts.sessions[eos].finish_reason == "eos"
    assert ts.sessions[sid].finish_reason == "length"
    assert ts.sessions[sid].generated == js.sessions[sid].generated


def test_state_roundtrip_mid_flight_matches_jax(setup):
    """state_tree -> load_state into a fresh scheduler reproduces the
    remaining stream exactly, which is the JAX scheduler's stream."""
    jcfg, cfg, jp, tp = setup
    geom = dict(page_size=4, n_pages=6, max_slots=2, max_seq_len=32)
    js, a = pair(setup, **geom)
    sids = [a.submit([s, s + 1], max_new_tokens=10) for s in (1, 5, 9)]
    for s in (1, 5, 9):
        js.submit([s, s + 1], max_new_tokens=10)
    for _ in range(4):
        a.step(now=0.0)
    tree = a.state_tree()
    tree = dict(tree, pool={k: v.clone() for k, v in tree["pool"].items()})
    b = DecodeScheduler(cfg, tp, init_pool=False, device="cpu", **geom)
    b.load_state(tree)
    assert {s: b.sessions[s].generated for s in b.sessions} == \
           {s: a.sessions[s].generated for s in a.sessions}
    drain(a), drain(b), drain(js)
    for sid in sids:
        assert a.sessions[sid].generated == b.sessions[sid].generated == \
            js.sessions[sid].generated
        assert b.sessions[sid].state == "done"


# ====================================================== BlockRuntime

def runtimes(setup, tmp_path, **job_kw):
    jcfg, cfg, jp, tp = setup
    jjob = JJob(jcfg, JShape("s", "serve", seq_len=32, global_batch=2),
                kind="serve", **job_kw)
    job = JobSpec(cfg, ShapeConfig("s", "serve", seq_len=32,
                                   global_batch=2), kind="serve", **job_kw)
    jrt = JRuntime(JGrant.new([(0, 0, 0)], (1, 1), 60.0), jjob,
                   [jax.devices()[0]], str(tmp_path / "ckpt"))
    jrt.init_state()
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), job,
                      devices=["cpu"])
    rt.init_state(params=interop.params_from_numpy(
        jax.tree.map(np.asarray, jrt.state["params"]), "cpu"))
    return jrt, rt


def test_dense_runtime_greedy_tokens_match_jax(setup, tmp_path):
    """init_state -> prefill -> step x n: the port's dense serve block
    emits the JAX block's greedy tokens."""
    jrt, rt = runtimes(setup, tmp_path)
    batch = pipeline.synthetic_batch(rt.job.cfg,
                                     ShapeConfig("p", "prefill", 8, 2),
                                     step=0, seed=3)
    jrt.prefill({"tokens": jax.numpy.asarray(batch["tokens"])})
    rt.prefill({"tokens": batch["tokens"]})
    want, got = [np.asarray(jrt.token)], [rt.token.numpy()]
    for _ in range(5):
        jrt.step()
        m = rt.step()
        assert m["step_s"] >= 0
        want.append(np.asarray(jrt.token))
        got.append(rt.token.numpy())
    assert np.array_equal(np.concatenate(got, 1), np.concatenate(want, 1))
    assert rt.step_count == 5 and rt.cache_len == 8 + 5


def test_session_api_emissions_match_jax(setup, tmp_path):
    """start_session / feed / harvest / idle_serve of a paged block give
    the JAX runtime's emissions, kind for kind and token for token, both
    client-driven (feed) and window-driven (dispatch + harvest)."""
    jrt, rt = runtimes(setup, tmp_path, paged=True, page_size=4,
                       max_slots=2)
    assert rt.idle_serve and jrt.idle_serve
    for r in (jrt, rt):
        r.sessions._time_fn = lambda: 0.0
        r.start_session([7, 8, 9], max_new_tokens=5)
        r.start_session([1, 2], max_new_tokens=3)
        r.start_session([4, 4, 4, 4], max_new_tokens=4)
    want, got = jrt.feed(rounds=2), rt.feed(rounds=2)
    assert got == want
    for r in (jrt, rt):
        r.dispatch()
        r.dispatch()
        assert len(r.drain()) == 2
    assert rt.harvest() == jrt.harvest()
    while jrt.sessions.has_work:
        want += jrt.feed()
    while not rt.idle_serve:
        got += rt.feed()
    assert [e["event"] for e in got] == [e["event"] for e in want]
    assert got == want
    assert rt.idle_serve and rt.step_count == jrt.step_count
    with pytest.raises(ValueError):
        rt.prefill({"tokens": np.zeros((1, 4), np.int32)})


def test_sampled_decode_is_seeded(setup):
    """Sampling draws from the scheduler's own generator: the same seed
    gives the same stream, another seed (almost surely) another one.  The
    draws are torch's, not jax.random's, so there is no JAX stream to
    match."""
    jcfg, cfg, jp, tp = setup

    def run(seed):
        s = DecodeScheduler(cfg, tp, page_size=4, max_slots=2,
                            max_seq_len=32, sample=True, seed=seed,
                            device="cpu")
        sids = [s.submit(p, max_new_tokens=12) for p in ([1, 2], [3])]
        drain(s)
        return [s.sessions[i].generated for i in sids]

    a = run(0)
    assert a == run(0) and a != run(1)
    assert all(0 <= t < cfg.vocab_size for g in a for t in g)


def test_chip_smoke_serve_phases_rehearse_on_cpu(capsys):
    """chip_smoke.py's serve phases at smoke size on the CPU (the plain
    versions run; no kernel launches), and its refusal without a card."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dense = smoke.phase_serve_dense(device="cpu", smoke=True)
    assert dense["logits_check"]["max_abs_err"] == 0.0   # same plain path
    paged = smoke.phase_serve_paged(device="cpu", smoke=True)
    assert paged["decode_rounds"] > 0 and paged["evictions"] == 0
    assert paged["logits_check"]["max_abs_err"] == 0.0
    admits = paged["admission_logits_checks"]
    assert [c["bucket"] for c in admits] == [32, 48]
    assert all(c["max_abs_err"] == 0.0 for c in admits)
    assert set(paged["launches"].values()) == {0}
    if not torch.cuda.is_available():
        assert smoke.main() == 2
    assert '"ok": true' not in capsys.readouterr().out


@pytest.mark.parametrize("sample", [False, True])
def test_launcher_main_on_cpu(capsys, sample):
    rc = launch_serve.main(["--arch", "deepseek_7b", "--smoke", "--device",
                            "cpu", "--batch", "2", "--prompt-len", "16",
                            "--gen", "4"] + (["--sample"] if sample else []))
    assert rc == 0
    out = capsys.readouterr().out
    assert "# prefill:" in out and "# decode:" in out


def test_runtime_rejects_what_later_slices_port(setup, tmp_path):
    """``overlap_comm`` without a mesh holding a pod axis and an unknown
    kind are refused.  The checkpoint calls work: with a ``ckpt_root`` a serve
    and a train block save, suspend, resume and restore at their step;
    without one they raise."""
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as train_lib
    jcfg, cfg, jp, tp = setup
    grant = BlockGrant.new([(0, 0, 0)], (1, 1), 60.0)
    shape = ShapeConfig("s", "train", seq_len=8, global_batch=1)
    with pytest.raises(ValueError, match="kind"):
        BlockRuntime(grant, JobSpec(cfg, shape, kind="eval"),
                     devices=["cpu"])
    for kind in ("serve", "train"):
        bare = BlockRuntime(grant, JobSpec(cfg, shape, kind=kind),
                            devices=["cpu"])
        for call in (bare.save, bare.suspend, bare.restore):
            with pytest.raises(ValueError, match="checkpoint root"):
                call()
        rt = BlockRuntime(grant, JobSpec(cfg, shape, kind=kind),
                          devices=["cpu"], ckpt_root=str(tmp_path / kind))
        rt.init_state()
        rt.step()
        rt.save(async_=False)
        assert rt.ckpt.steps() == [1] and rt.progress_lost == 0
        assert rt.suspend()["step"] == 1 and rt.state is None
        assert rt.resume(grant, ["cpu"]) == 1 and not rt.suspended
        assert rt.restore() == 1 and rt.step_count == 1
    # overlap_comm is ported: without a mesh holding a pod axis it is
    # the reference's assertion
    with pytest.raises(AssertionError):
        train_lib.make_train_step(cfg, shape, opt_lib.OptConfig(),
                                  overlap_comm=True)



# ================================================= the hybrid family

def _load_chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_hybrid_launcher_tokens_match_jax(monkeypatch, capsys):
    """``launch.serve --arch zamba2_2p7b --smoke --device cpu`` emits the
    token stream that JAX's greedy prefill/decode gives on the same
    params and prompts.  The smoke config is made fp32 on both sides: in
    bf16 the two frameworks round differently enough (see
    tests/test_torch_models.py) that a near tie can flip an argmax."""
    import dataclasses

    import repro.configs as jconfigs
    import repro_torch.configs as configs
    get_smoke = configs.get_smoke
    monkeypatch.setattr(configs, "get_smoke", lambda a: dataclasses.replace(
        get_smoke(a), param_dtype="float32"))
    args = launch_serve.parse_args(
        ["--arch", "zamba2_2p7b", "--smoke", "--device", "cpu", "--batch",
         "2", "--prompt-len", "20", "--gen", "8"])
    res = launch_serve.run(args)
    assert res["cfg"].family == "hybrid"
    got = res["tokens"]
    jcfg = jconfigs.get_smoke("zamba2_2p7b").replace(param_dtype="float32")
    jp = jax.tree.map(jax.numpy.asarray, interop.params_to_numpy(
        res["runtime"].state["params"]))
    prompt = jax.numpy.asarray(res["batch"]["tokens"])
    cache = jmodel.init_cache(jcfg, 2, 28)
    logits, cache = jmodel.prefill(jp, jcfg, {"tokens": prompt}, cache)
    want = []
    for i in range(8):
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        want.append(tok)
        if i < 7:
            logits, cache = jmodel.decode_step(
                jp, jcfg, jax.numpy.asarray(tok), cache,
                jax.numpy.int32(20 + i))
    assert np.array_equal(got, np.concatenate(want, 1))
    assert launch_serve.main(["--arch", "zamba2_2p7b", "--smoke", "--device",
                              "cpu", "--batch", "2", "--prompt-len", "16",
                              "--gen", "3"]) == 0
    assert "zamba2_2p7b_smoke" in capsys.readouterr().out


def test_hybrid_paged_and_train_jobs_raise():
    """The hybrid's recurrent state does not page (the reference's
    ``ValueError``); its train block runs on the CPU (the SSD scan's plain
    version under autograd; on the card its backward kernel), through
    ``BlockRuntime``, ``make_train_state`` and ``make_train_step``."""
    import repro_torch.configs as configs
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import train_step as train_lib
    cfg = configs.get_smoke("zamba2_2p7b")
    grant = BlockGrant.new([(0, 0, 0)], (1, 1), 60.0)
    serve_shape = ShapeConfig("s", "serve", seq_len=16, global_batch=1)
    with pytest.raises(ValueError, match="paged decode unsupported"):
        rt = BlockRuntime(grant, JobSpec(cfg, serve_shape, kind="serve",
                                         paged=True), devices=["cpu"])
        rt.init_state()
    with pytest.raises(ValueError, match="paged decode unsupported"):
        DecodeScheduler(cfg, {}, device="cpu")
    train_shape = ShapeConfig("s", "train", seq_len=16, global_batch=1)
    rt = BlockRuntime(grant, JobSpec(cfg, train_shape, kind="train"),
                      devices=["cpu"])
    rt.init_state()
    m = rt.step()
    assert np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
    assert rt.step_count == 1
    state = train_lib.make_train_state(cfg, 0, opt_lib.OptConfig(),
                                       device="cpu")
    step = train_lib.make_train_step(cfg, train_shape, opt_lib.OptConfig())
    state, m = step(state, rt.data.batch(1))
    assert torch.isfinite(m["loss"]) and int(state["opt"]["step"]) == 1
    # a dense serve block of the hybrid runs
    rt = BlockRuntime(grant, JobSpec(cfg, serve_shape, kind="serve"),
                      devices=["cpu"])
    rt.init_state()
    rt.prefill({"tokens": np.zeros((1, 8), np.int32)})
    rt.step()
    assert rt.cache_len == 9 and set(rt.cache) == {"mamba", "attn"}


def test_chip_smoke_hybrid_phase_rehearses_on_cpu():
    """chip_smoke.py's serve_hybrid phase at smoke size on the CPU (the
    plain versions run; no kernel launches), and the launch counts it
    holds the card to at full width: 45 SSD scans, 9 flash attentions and
    109 RMSNorms a prefill, 109 RMSNorms a decode step."""
    import repro_torch.configs as configs
    smoke = _load_chip_smoke()
    out = smoke.phase_serve_hybrid(device="cpu", smoke=True)
    for chk in (out["logits_check"], out["first_decode_logits_check"]):
        assert chk["f32"]["max_abs_err"] == 0.0           # same plain path
        assert chk["bf16_whole_stack"]["max_abs_err"] == 0.0
    groups = out["bf16_group_check"]
    assert len(groups["prefill"]) == len(groups["decode"]) == 2
    assert groups["worst"] == {"prefill": 0.0, "decode": 0.0}
    assert all(r["update_range"] > 0 and r["finite"]
               for r in groups["prefill"] + groups["decode"])
    assert set(out["launches"].values()) == {0}
    pre, dec = smoke.hybrid_launches(configs.get("zamba2_2p7b"))
    assert (pre["ssd_scan"], pre["flash_attention"], pre["rmsnorm"]) == \
        (45, 9, 109)
    assert (dec["ssd_scan"], dec["flash_attention"], dec["rmsnorm"]) == \
        (0, 0, 109)
    assert smoke.KERNEL_META["ssd_scan"]["replaces"] == \
        "src/repro/kernels/ssd_scan.py:20"


def test_chip_smoke_hybrid_group_check_catches_a_bf16_fault(monkeypatch):
    """The bf16 group check fails when the SSD scan goes wrong in bf16
    only (one head's outputs zeroed on the kernels' side), where the fp32
    whole-stack check cannot see it."""
    from repro_torch.kernels import ops
    smoke = _load_chip_smoke()
    real = ops.ssd_scan

    def faulty(*args, impl="auto", **kw):
        y, h = real(*args, impl=impl, **kw)
        if impl != "torch" and y.dtype == torch.bfloat16:
            y = y.clone()
            y[:, :, 0] = 0
        return y, h

    monkeypatch.setattr(ops, "ssd_scan", faulty)
    with pytest.raises(SystemExit, match="hybrid bf16 groups"):
        smoke.phase_serve_hybrid(device="cpu", smoke=True)
