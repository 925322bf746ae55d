"""The moe family (deepseek_v2_236b: MLA attention, 2 shared + routed
experts, every layer MoE; llama4_maverick_400b: GQA, top-1 routing, dense
and MoE layers alternating) in the port against the JAX package, on the
CPU at ``get_smoke`` in fp32.

Both packages start from the same params (made by the reference's init
functions and moved across with ``interop``) and the same numpy inputs
from a seed; the JAX runs are the reference.  Held: ``moe_fwd``'s output
and aux loss at the default capacity factor (where the test first shows
that a choice is dropped, so the overflow path runs) and at 16; MLA's
prefill and its absorbed decode step by step; both configs' ``forward``
logits and aux, prefill and decode; llama4 on the port's paged plane
against the reference's dense decode; the active-param count and the
roofline at full size; the flash backward's named refusal past MLA's
head dims; chip_smoke's ``serve_moe`` at smoke size.  Training is held in
``tests/test_torch_moe_train.py``.

Tolerance: fp32 ``atol=1e-5, rtol=1e-4``, as ``tests/test_torch_models.py``
(XLA:CPU and ATen sum matmuls in different orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.block import BlockGrant  # noqa: E402
from repro_torch.core.runtime import BlockRuntime, JobSpec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.models import layers, model, moe  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.transformer import flatten  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

F32_TOL = dict(atol=1e-5, rtol=1e-4)
ARCHS = ("deepseek_v2_236b", "llama4_maverick_400b")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_params(jp):
    return interop.params_from_numpy(np_tree(jp), "cpu")


def cfgs(arch, **moe_kw):
    """The smoke config in both packages, fp32, with ``moe_kw`` replacing
    fields of its MoE config."""
    out = []
    for get in (jconfigs.get_smoke, configs.get_smoke):
        c = get(arch).replace(param_dtype="float32")
        if moe_kw:
            c = c.replace(moe=dataclasses.replace(c.moe, **moe_kw))
        out.append(c)
    return tuple(out)


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               **(tol or F32_TOL))


def prompt_of(cfg, B, T, seed=4):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)


# ================================================================ the layer

@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
def test_moe_fwd_vs_reference(capacity_factor):
    """deepseek_v2's smoke MoE layer (8 experts, top-2, 2 shared) on 2 x
    24 tokens.  At the default capacity factor some choices overflow (the
    test shows at least one) and are dropped by the scatter; at 16 none
    is.  The output and the aux loss, fp32."""
    jcfg, cfg = cfgs("deepseek_v2_236b", capacity_factor=capacity_factor)
    d = cfg.d_model
    jp = jmoe.moe_init(jax.random.PRNGKey(7), d, jcfg.moe, jnp.float32)
    p = port_params(jp)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 24, d), dtype=np.float32)
    _, _, slots, weights, C = moe.route(
        torch.from_numpy(x).reshape(-1, d), p["router"], cfg.moe)
    dropped = int((slots == cfg.moe.n_experts * C).sum())
    if capacity_factor == 1.25:
        assert dropped > 0, "no choice overflowed: the drop path is not run"
        assert bool((weights[slots == cfg.moe.n_experts * C] == 0).all())
    else:
        assert dropped == 0
    want, waux = jmoe.moe_fwd(jp, jnp.asarray(x), jcfg.moe, jcfg.act)
    got, gaux = moe.moe_fwd(p, torch.from_numpy(x), cfg.moe, cfg.act)
    assert_close(got, want)
    assert_close(gaux, waux)


def test_moe_scatter_keeps_every_valid_row_and_drops_the_overflow():
    """Each valid slot holds exactly its token; a slot nobody took is 0;
    the combine reads an overflow choice at row E * C - 1 weighted 0."""
    E, C, d = 3, 2, 4
    xs = torch.arange(5 * d, dtype=torch.float32).reshape(5, d) + 1
    slots = torch.tensor([[0, 2, 6, 4, 6], [1, 6, 3, 6, 5]])
    buf = moe._scatter_local(xs, slots, E=E, C=C)
    assert buf.shape == (E * C, d)
    for j, t in ((0, 0), (0, 1), (0, 3), (1, 0), (1, 2), (1, 4)):
        assert torch.equal(buf[slots[j, t]], xs[t])
    w = torch.tensor([[1.0, 1.0, 0.0, 1.0, 0.0], [0.5, 0.0, 1.0, 0.0, 2.0]])
    out = moe._combine_local(buf, slots, w, E=E, C=C)
    want = xs * w[0, :, None] + buf[torch.clamp(slots[1], max=5)] \
        * w[1, :, None]
    assert torch.equal(out, want)


# ================================================================ MLA

def mla_setup(seed=9):
    jcfg, cfg = cfgs("deepseek_v2_236b")
    jp = jlayers.mla_init(jax.random.PRNGKey(seed), cfg.d_model,
                          jcfg.attention, jnp.float32)
    return jcfg, cfg, jp, port_params(jp)


def test_mla_prefill_vs_reference():
    """MLA's prefill: per-head K and V at head dim 16 + 8, flash attention
    (its plain version here), and the compressed cache rows [0, S) written
    and the rest zeroed."""
    jcfg, cfg, jp, p = mla_setup()
    rng = np.random.default_rng(10)
    S, smax = 7, 12
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    a = cfg.attention
    jcache = {"c_kv": jnp.zeros((2, smax, a.kv_lora_rank)),
              "k_rope": jnp.zeros((2, smax, a.qk_rope_head_dim))}
    cache = {"c_kv": torch.full((2, smax, a.kv_lora_rank), 3.0),
             "k_rope": torch.full((2, smax, a.qk_rope_head_dim), 3.0)}
    pos = np.arange(S, dtype=np.int32)
    want, wc = jlayers.mla_fwd(jp, jnp.asarray(x), jcfg.attention,
                               positions=jnp.asarray(pos), cache=jcache,
                               cache_len=0)
    got, gc = layers.mla_fwd(p, torch.from_numpy(x), a,
                             positions=torch.from_numpy(pos), cache=cache,
                             cache_len=0)
    assert_close(got, want)
    for k in ("c_kv", "k_rope"):
        assert_close(gc[k], wc[k])
    # no cache: the train branch
    want, _ = jlayers.mla_fwd(jp, jnp.asarray(x), jcfg.attention,
                              positions=jnp.asarray(pos))
    got, _ = layers.mla_fwd(p, torch.from_numpy(x), a,
                            positions=torch.from_numpy(pos))
    assert_close(got, want)


def test_mla_kv_norm_reads_kv_a_in_place_vs_reference(monkeypatch):
    """MLA's prefill hands kv_norm the slice kv_a[..., :R] of its
    (R + Dr)-wide rows as a view, with no copy, and its output and
    compressed cache still match the reference's."""
    from repro_torch.kernels import ops
    jcfg, cfg, jp, p = mla_setup()
    a = cfg.attention
    R, width = a.kv_lora_rank, a.kv_lora_rank + a.qk_rope_head_dim
    seen = []
    plain = ops.rmsnorm

    def rmsnorm(x, scale, **kw):
        seen.append(x)
        return plain(x, scale, **kw)

    monkeypatch.setattr(ops, "rmsnorm", rmsnorm)
    rng = np.random.default_rng(12)
    S, smax = 5, 8
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    pos = np.arange(S, dtype=np.int32)
    jcache = {"c_kv": jnp.zeros((2, smax, R)),
              "k_rope": jnp.zeros((2, smax, a.qk_rope_head_dim))}
    cache = {"c_kv": torch.zeros((2, smax, R)),
             "k_rope": torch.zeros((2, smax, a.qk_rope_head_dim))}
    want, wc = jlayers.mla_fwd(jp, jnp.asarray(x), jcfg.attention,
                               positions=jnp.asarray(pos), cache=jcache,
                               cache_len=0)
    got, gc = layers.mla_fwd(p, torch.from_numpy(x), a,
                             positions=torch.from_numpy(pos), cache=cache,
                             cache_len=0)
    kv = [t for t in seen if t.shape[-1] == R]
    assert len(kv) == 1 and not kv[0].is_contiguous()
    assert kv[0].stride()[-2] == width
    assert_close(got, want)
    for k in ("c_kv", "k_rope"):
        assert_close(gc[k], wc[k])


def test_mla_absorbed_decode_steps_vs_reference():
    """Five absorbed decode steps after a prefill: each step's output and
    the compressed cache, the position a 0-d device tensor (the captured
    step's form)."""
    jcfg, cfg, jp, p = mla_setup(11)
    a = cfg.attention
    rng = np.random.default_rng(12)
    S, smax = 6, 12
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    jcache = {"c_kv": jnp.zeros((2, smax, a.kv_lora_rank)),
              "k_rope": jnp.zeros((2, smax, a.qk_rope_head_dim))}
    cache = {"c_kv": torch.zeros((2, smax, a.kv_lora_rank)),
             "k_rope": torch.zeros((2, smax, a.qk_rope_head_dim))}
    pos = np.arange(S, dtype=np.int32)
    _, jcache = jlayers.mla_fwd(jp, jnp.asarray(x), jcfg.attention,
                                positions=jnp.asarray(pos), cache=jcache,
                                cache_len=0)
    layers.mla_fwd(p, torch.from_numpy(x), a,
                   positions=torch.from_numpy(pos), cache=cache,
                   cache_len=0)
    for i in range(5):
        n = S + i
        xt = rng.standard_normal((2, 1, cfg.d_model), dtype=np.float32)
        want, jcache = jlayers.mla_fwd(
            jp, jnp.asarray(xt), jcfg.attention,
            positions=jnp.asarray([n], jnp.int32), cache=jcache,
            cache_len=jnp.int32(n))
        cl = torch.tensor(n, dtype=torch.int32)
        got, cache = layers.mla_fwd(
            p, torch.from_numpy(xt), a, positions=cl + torch.arange(1),
            cache=cache, cache_len=cl)
        assert_close(got, want)
        for k in ("c_kv", "k_rope"):
            assert_close(cache[k], jcache[k])


# ================================================================ the stack

@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    jcfg, cfg = cfgs(request.param)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    return jcfg, cfg, jp, port_params(jp)


def test_forward_logits_and_aux_vs_reference(fam):
    """The whole stack on 2 x 16 tokens: logits and the summed aux loss."""
    jcfg, cfg, jp, p = fam
    toks = prompt_of(cfg, 2, 16)
    jx = jmodel.embed_inputs(jp, jcfg, {"tokens": jnp.asarray(toks)})
    x = model.embed_inputs(p, cfg, {"tokens": torch.from_numpy(toks)})
    want, waux, _ = jmodel.forward(jp, jcfg, jx, positions=jnp.arange(16))
    got, gaux, _ = model.forward(p, cfg, x, positions=torch.arange(16))
    assert_close(got, want)
    assert_close(gaux, waux)
    assert float(gaux) > 0


def test_prefill_and_decode_vs_reference(fam):
    """Prefill of 2 x 10 tokens and 5 greedy decode steps: every logit and
    the cache tree (MLA's {c_kv, k_rope}, llama4's {dense, moe})."""
    jcfg, cfg, jp, p = fam
    toks = prompt_of(cfg, 2, 10, seed=6)
    smax = 16
    jcache = jmodel.init_cache(jcfg, 2, smax)
    cache = model.init_cache(cfg, 2, smax, "cpu")
    assert ({k for k, _ in flatten(cache)}
            == {k for k, _ in flatten(np_tree(jcache))})
    wl, jcache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                jcache)
    gl, cache = model.prefill(p, cfg, {"tokens": torch.from_numpy(toks)},
                              cache)
    assert_close(gl, wl)
    tok = np.argmax(np.asarray(wl), -1).astype(np.int32)[:, None]
    for i in range(5):
        n = toks.shape[1] + i
        wl, jcache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                        jnp.int32(n))
        gl, cache = model.decode_step(p, cfg, torch.from_numpy(tok), cache,
                                      torch.tensor(n, dtype=torch.int32))
        assert_close(gl, wl)
        tok = np.argmax(np.asarray(wl), -1).astype(np.int32)[:, None]
    want = dict(flatten(np_tree(jcache)))
    for k, t in flatten(cache):
        assert_close(t, want[k])


def reference_greedy(jp, jcfg, prompt, n):
    """The reference's model-level greedy tokens for one prompt (batch 1,
    the dense cache)."""
    toks = np.asarray([prompt], np.int32)
    cache = jmodel.init_cache(jcfg, 1, len(prompt) + n)
    logits, cache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                   cache)
    out = [int(np.argmax(np.asarray(logits)[0]))]
    for i in range(n - 1):
        logits, cache = jmodel.decode_step(
            jp, jcfg, jnp.asarray([[out[-1]]], jnp.int32), cache,
            jnp.int32(len(prompt) + i))
        out.append(int(np.argmax(np.asarray(logits)[0])))
    return out


def paged_block(cfg, params, root=None):
    job = JobSpec(cfg, ShapeConfig("p", "serve", seq_len=40, global_batch=1),
                  kind="serve", seed=0, paged=True, page_size=4,
                  max_slots=3, max_seq_len=40, ckpt_namespace="l4")
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), job,
                      devices=["cpu"], ckpt_root=root)
    rt.init_state(params=params)
    return rt


def paged_prompts(cfg):
    rng = np.random.default_rng(13)
    return [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 9, 13,
                                                                  7)]


def session_tokens(ems):
    out = {}
    for e in ems:
        if e["event"] == "token":
            out.setdefault(e["session"], []).append(e["token"])
    return out


def test_llama4_paged_plane_vs_reference_dense_decode(tmp_path):
    """llama4 on the port's paged plane: 4 sessions through 3 slots (a
    {dense, moe} page pool, page-padded admission prefills, idle slots in
    the decode rounds), each session's 6 greedy tokens the reference's
    dense decode of its prompt alone.  At capacity factor 16 no choice
    overflows, so the paged batch's idle slots and pad tokens, which take
    capacity, change nothing.  Then the same traffic suspended after 3
    rounds and resumed (the nested pool through a checkpoint): the same
    tokens."""
    jcfg, cfg = cfgs("llama4_maverick_400b", capacity_factor=16.0)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(14))
    prompts = paged_prompts(cfg)
    want = [reference_greedy(jp, jcfg, pr, 6) for pr in prompts]

    def run(rt, stop=None):
        sids = [rt.start_session(pr, max_new_tokens=6) for pr in prompts]
        ems, n = [], 0
        while not rt.idle_serve and (stop is None or n < stop):
            ems.extend(rt.feed())
            n += 1
        return sids, ems

    rt = paged_block(cfg, port_params(jp))
    assert set(rt.sessions.pool) == {"dense", "moe"}
    sids, ems = run(rt)
    got = session_tokens(ems)
    assert [got[s] for s in sids] == want

    rt = paged_block(cfg, port_params(jp), str(tmp_path))
    sids, ems = run(rt, stop=3)
    rt.suspend()
    assert rt.sessions is None or rt.sessions.pool is None
    rt.resume(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), ["cpu"])
    while not rt.idle_serve:
        ems.extend(rt.feed())
    got = session_tokens(ems)
    assert [got[s] for s in sids] == want


def test_mla_refuses_the_paged_plane():
    _, cfg = cfgs("deepseek_v2_236b")
    with pytest.raises(ValueError, match="MLA"):
        model.init_paged_cache(cfg, 4, 4, "cpu")


# ============================================================ full size

@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_roofline_at_full_size(arch):
    """The routed-expert discount at full size (on the ``meta`` device):
    the reference's active count and its model FLOPs for a prefill and a
    decode step, so a MoE block's MFU counts only the experts it uses."""
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    got = model.count_active_params(cfg)
    assert got == jmodel.count_active_params(jcfg)
    assert got < model.count_params(model.abstract_params(cfg))
    for kind, seq, batch in (("prefill", 512, 4), ("decode", 1, 4)):
        assert hlo_analysis.model_step_flops(
            cfg, ShapeConfig("s", kind, seq, batch)) == \
            jhlo.model_step_flops(jcfg, JShape("s", kind, seq, batch))


def test_flash_backward_refuses_mla_head_dim_naming_its_slice():
    """The backward takes MLA's head dims since the MoE training slice (D
    <= 192, Dv <= 128, as the forward).  Past them it refuses naming its
    limits, before it looks at the device (D = 200, Dv = 136); within them
    a CPU tensor is refused for its device (the kernel runs on the card
    only)."""
    assert fa.MAX_HEAD_DIM == fa.MAX_BWD_HEAD_DIM == 192
    assert fa.MAX_V_HEAD_DIM == 128
    for D, Dv in ((200, 128), (192, 136)):
        q = torch.zeros((1, 2, 4, D))
        v = torch.zeros((1, 2, 4, Dv))
        lse = torch.zeros((1, 2, 4))
        with pytest.raises(ValueError, match=r"head dims {} \| {} past the "
                           r"kernel's MAX_BWD_HEAD_DIM 192 \| MAX_V_HEAD_DIM "
                           r"128".format(D, Dv)):
            fa.flash_attention_bwd_cuda(q, q, v, v, lse, v)
    q = torch.zeros((1, 2, 4, 192))
    v = torch.zeros((1, 2, 4, 128))
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="one CUDA device"):
        fa.flash_attention_bwd_cuda(q, q, v, v, lse, v)
    o = fa.flash_attention_torch(q, q, v)
    assert o.shape == v.shape


# ======================================================= chip_smoke's phase

def test_chip_smoke_serve_moe_rehearses_on_cpu():
    """``chip_smoke.py``'s ``serve_moe`` at smoke size on the CPU: every
    decode step eager, no kernel launched, the logits against
    ``impl="torch"``, the capacity drop shares in [0, 1]."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out = smoke.phase_serve_moe(device="cpu", smoke=True)
    assert out["arch"] == "deepseek_v2_236b_smoke"
    assert out["decode_graph"]["eager_calls"] == out["gen"] - 1
    assert out["logits_check"]["passed"]
    assert out["captured_vs_eager"]["tokens_equal"]
    assert set(out["launches"].values()) == {0}
    for k in ("prefill", "decode"):
        assert 0.0 <= out["capacity_drop"][k]["dropped_share"] <= 1.0
