"""The port's dense model against the JAX package with the same params.

Params are made by ``repro.models.model.init_params`` and moved across
with ``repro_torch.interop``; activations are made from a seed with numpy.
On the CPU the port runs its kernels' plain versions.

Tolerances: fp32 ``atol=1e-5, rtol=1e-4`` (XLA:CPU and ATen sum matmuls in
different orders); bf16 logits ``atol=rtol=2e-2`` scaled by the logits'
range (every layer rounds its activations to bf16, and the two frameworks
can round a sum to different neighbours).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import AttentionConfig as JAttn  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.config import SSMConfig as JSSM  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import layers, model, ssm  # noqa: E402
from repro_torch.models.config import (AttentionConfig, ModelConfig,  # noqa: E402
                                       SSMConfig)
from repro_torch.models.transformer import Transformer, flatten  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

F32_TOL = dict(atol=1e-5, rtol=1e-4)

TINY = dict(name="serve_t", family="dense", n_layers=2, d_model=32,
            vocab_size=64, d_ff=64, param_dtype="float32")


def tiny_cfgs():
    """The tiny GQA config of tests/test_serve.py in both packages."""
    return (JModelConfig(**TINY, attention=JAttn(n_heads=4, n_kv_heads=2,
                                                 head_dim=8)),
            ModelConfig(**TINY, attention=AttentionConfig(
                n_heads=4, n_kv_heads=2, head_dim=8)))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    jcfg, cfg = tiny_cfgs()
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, interop.params_from_numpy(np_tree(jp), "cpu")


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), **(tol or F32_TOL))


# ------------------------------------------------------------- params

@pytest.mark.parametrize("which", ["tiny_f32", "deepseek_7b_smoke_bf16",
                                   "zamba2_2p7b_smoke_bf16"])
def test_params_roundtrip_and_layout(which):
    """JAX params -> port -> numpy is bit-exact leaf for leaf, and the
    port's own init draws the same tree of shapes and dtypes (for the
    hybrid: ``extra``, (n_groups, m, ...) Mamba2 leaves, fp32 ``A_log``,
    ``D`` and ``dt_bias`` inside a bf16 model)."""
    if which == "tiny_f32":
        jcfg, cfg = tiny_cfgs()
    else:
        arch = which[:-len("_smoke_bf16")]
        jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    jp = np_tree(jmodel.init_params(jcfg, jax.random.PRNGKey(1)))
    tp = interop.params_from_numpy(jp, "cpu")
    back = interop.params_to_numpy(tp)
    j_leaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    b_leaves = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in j_leaves] == [p for p, _ in b_leaves]
    for (_, a), (_, b) in zip(j_leaves, b_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    own = model.init_params(cfg, seed=0, device="cpu")
    own_shapes = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
                  for p, t in flatten(own)}
    tp_shapes = {p: (tuple(t.shape), str(t.dtype).split(".")[-1])
                 for p, t in flatten(tp)}
    assert own_shapes == tp_shapes
    assert cfg.param_count() == jcfg.param_count()
    assert model.count_params(model.abstract_params(cfg)) == \
        jmodel.count_params(jp)


# ------------------------------------------------------------- layers

@pytest.mark.parametrize("pos_shape", [(5,), (2, 5)])
def test_apply_rope_vs_jax(pos_shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 8), dtype=np.float32)
    pos = rng.integers(0, 50, pos_shape).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0)
    assert_close(got, want)


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_apply_norm_vs_jax(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 16), dtype=np.float32)
    p = {"scale": rng.standard_normal(16, dtype=np.float32)}
    if kind == "layer":
        p["bias"] = rng.standard_normal(16, dtype=np.float32)
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), kind)
    got = layers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), kind)
    assert_close(got, want)


@pytest.mark.parametrize("branch", ["train", "prefill", "decode"])
def test_attention_fwd_branches_vs_jax(tiny, branch):
    jcfg, cfg, jp, tp = tiny
    rng = np.random.default_rng(2)
    S, smax = (1, 12) if branch == "decode" else (6, 12)
    x = rng.standard_normal((2, S, cfg.d_model), dtype=np.float32)
    jattn = jax.tree.map(lambda t: t[0], jp["layers"]["attn"])
    tattn = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    a = cfg.attention
    cache = jcache = None
    cache_len = None
    if branch != "train":
        c = rng.standard_normal((2, smax, a.n_kv_heads, a.head_dim),
                                dtype=np.float32)
        jcache = {"k": jnp.asarray(c), "v": jnp.asarray(c * 0.5)}
        cache = {"k": torch.from_numpy(c.copy()),
                 "v": torch.from_numpy(c * 0.5)}
    if branch == "decode":
        cache_len = 7
        pos = np.asarray([cache_len], np.int32)
    else:
        pos = np.arange(S, dtype=np.int32)
    want, wc = jlayers.attention_fwd(
        jattn, jnp.asarray(x), jcfg.attention, positions=jnp.asarray(pos),
        cache=jcache,
        cache_len=None if cache_len is None else jnp.int32(cache_len))
    got, gc = layers.attention_fwd(
        tattn, torch.from_numpy(x), a, positions=torch.from_numpy(pos),
        cache=cache,
        cache_len=None if cache_len is None else torch.tensor(
            cache_len, dtype=torch.int32))
    assert_close(got, want)
    if branch != "train":
        for k in ("k", "v"):
            assert_close(gc[k], wc[k])


# ------------------------------------------------------------- the stack

def test_prefill_and_decode_steps_vs_jax(tiny):
    """Prefill logits and cache, then three dense decode steps."""
    jcfg, cfg, jp, tp = tiny
    prompt = np.asarray([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], np.int32)
    smax = 16
    jcache = jmodel.init_cache(jcfg, 2, smax)
    cache = model.init_cache(cfg, 2, smax, "cpu")
    wl, jcache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                jcache)
    gl, cache = model.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                              cache)
    assert_close(gl, wl)
    for k in ("k", "v"):
        assert_close(cache[k], jcache[k])
    tok = np.argmax(np.asarray(wl), -1).astype(np.int32)[:, None]
    for i in range(3):
        n = prompt.shape[1] + i
        wl, jcache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                        jnp.int32(n))
        gl, cache = model.decode_step(tp, cfg, torch.from_numpy(tok), cache,
                                      torch.tensor(n, dtype=torch.int32))
        assert_close(gl, wl)
        for k in ("k", "v"):
            assert_close(cache[k], jcache[k])
        tok = np.argmax(np.asarray(wl), -1).astype(np.int32)[:, None]


def test_paged_decode_steps_vs_jax(tiny):
    """Admission-style prefill scattered into pages, then three batched
    ``decode_step_paged`` steps over two slots (one idle on the trash
    page)."""
    jcfg, cfg, jp, tp = tiny
    page, maxp = 4, 4
    prompt = np.asarray([[3, 1, 4, 1, 5]], np.int32)
    jcache = jmodel.init_cache(jcfg, 1, 8)
    cache = model.init_cache(cfg, 1, 8, "cpu")
    wl, jcache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                jcache)
    gl, cache = model.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                              cache)
    jpool = jmodel.init_paged_cache(jcfg, n_pages=maxp + 1, page_size=page)
    pool = model.init_paged_cache(cfg, maxp + 1, page, "cpu")
    jpool = jmodel.write_prefill_to_pages(jpool, jcache, [2, 3], page)
    pool = model.write_prefill_to_pages(pool, cache, [2, 3], page)
    for k in ("k", "v"):
        assert_close(pool[k], jpool[k])
    table = np.asarray([[2, 3, 1, 0], [0, 0, 0, 0]], np.int32)
    lens = np.asarray([5, 0], np.int32)
    tok = np.zeros((2, 1), np.int32)
    tok[0, 0] = int(np.argmax(np.asarray(wl)[0]))
    for _ in range(3):
        wl, jpool = jmodel.decode_step_paged(
            jp, jcfg, jnp.asarray(tok), jpool, jnp.asarray(table),
            jnp.asarray(lens))
        gl, pool = model.decode_step_paged(
            tp, cfg, torch.from_numpy(tok), pool, torch.from_numpy(table),
            torch.from_numpy(lens))
        assert_close(gl[0], wl[0])       # slot 1 is idle garbage in both
        for k in ("k", "v"):
            assert_close(pool[k][:, 1:], jpool[k][:, 1:])
        tok[0, 0] = int(np.argmax(np.asarray(wl)[0]))
        lens[0] += 1


def test_deepseek_smoke_bf16_prefill_vs_jax():
    """The slice's model family at smoke size in its own dtype (bf16)."""
    jcfg = jconfigs.get_smoke("deepseek_7b")
    cfg = configs.get_smoke("deepseek_7b")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(3))
    net = Transformer(cfg, interop.params_from_numpy(np_tree(jp), "cpu"),
                      device="cpu")
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    wl, _ = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                           jmodel.init_cache(jcfg, 2, 16))
    gl, _ = model.prefill(net.params, cfg,
                          {"tokens": torch.from_numpy(prompt)},
                          model.init_cache(cfg, 2, 16, "cpu"))
    assert gl.dtype == torch.bfloat16
    want = np.asarray(wl, np.float32)
    span = float(np.abs(want).max())
    assert_close(gl, want, atol=2e-2 * span, rtol=2e-2)


def test_unported_families_raise(monkeypatch):
    """Every family is ported: xlstm resolves to the reference's config.
    The refusal of an arch whose family is not ported stays, shown with a
    stand-in entry in ``configs._NOT_PORTED``; an unknown arch is a
    ``KeyError``."""
    import dataclasses
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        assert dataclasses.asdict(get("xlstm_350m")) == dataclasses.asdict(
            jget("xlstm_350m"))
    monkeypatch.setitem(configs._NOT_PORTED, "yi_34b", "dense")
    for get in (configs.get, configs.get_smoke):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            get("yi_34b")
    with pytest.raises(KeyError):
        configs.get("no_such_arch")
    assert configs.get("deepseek_7b").d_model == 4096


# ------------------------------------------------------------ the hybrid

SSM_KW = dict(state_dim=16, head_dim=8, expand=2, chunk=8)
D_MODEL = 32


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_vs_jax(with_tail):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 12), dtype=np.float32)
    w = rng.standard_normal((4, 12), dtype=np.float32)
    tail = rng.standard_normal((2, 3, 12), dtype=np.float32)
    jt = jnp.asarray(tail) if with_tail else None
    tt = torch.from_numpy(tail) if with_tail else None
    want, wtail = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w), jt)
    got, gtail = ssm.causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                 tt)
    assert_close(got, want)
    assert_close(gtail, wtail)


@pytest.mark.parametrize("branch", ["no_state", "state_prefill",
                                    "state_decode"])
def test_mamba2_fwd_branches_vs_jax(branch):
    """No state (train): the chunked scan from zeros; a state with S > 1
    (prefill into a cache): the scan from h0 and the conv tail; S == 1
    with a state (decode): ``ssd_decode_step``.  The output and the new
    state, fp32."""
    jc, c = JSSM(**SSM_KW), SSMConfig(**SSM_KW)
    jp = jssm.mamba2_init(jax.random.PRNGKey(6), D_MODEL, jc, jnp.float32)
    rng = np.random.default_rng(7)
    # nonzero decay, skip and bias so every term is exercised
    jp = dict(jp,
              A_log=jnp.asarray(rng.standard_normal(8) * 0.3, jnp.float32),
              D=jnp.asarray(rng.standard_normal(8), jnp.float32),
              dt_bias=jnp.asarray(rng.standard_normal(8), jnp.float32))
    tp = interop.params_from_numpy(np_tree(jp), "cpu")
    S = {"no_state": 19, "state_prefill": 11, "state_decode": 1}[branch]
    x = rng.standard_normal((2, S, D_MODEL), dtype=np.float32)
    jstate = state = None
    if branch != "no_state":
        # conv tail: (B, W - 1, di + 2N) with di = 2 * 32, N = 16
        conv = rng.standard_normal((2, 3, 96), dtype=np.float32)
        h = rng.standard_normal((2, 8, 8, 16), dtype=np.float32) * 0.5
        jstate = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(h)}
        state = {"conv": torch.from_numpy(conv.copy()),
                 "ssm": torch.from_numpy(h.copy())}
    want, wst = jssm.mamba2_fwd(jp, jnp.asarray(x), jc, D_MODEL,
                                state=jstate)
    got, gst = ssm.mamba2_fwd(tp, torch.from_numpy(x), c, D_MODEL,
                              state=state)
    assert_close(got, want)
    for k in ("conv", "ssm"):
        assert_close(gst[k], wst[k])
    if state is not None:
        assert gst is state        # written back in place


def xla_bf16_silu(t):
    """silu with each op rounded to the input's dtype, as XLA:CPU computes
    ``jax.nn.silu`` in bf16: exp(-x), 1 + e, 1 / d and x * r.  ``F.silu``
    computes in fp32 and rounds once."""
    return t * torch.reciprocal(1 + torch.exp(-t))


def test_xla_bf16_silu_matches_jax_bitwise():
    """``xla_bf16_silu`` is ``jax.nn.silu`` bit for bit on bf16 inputs,
    and ``F.silu`` is not (it rounds a third of them differently)."""
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.standard_normal(100_000) * 4, jnp.bfloat16)
    want = np.asarray(jax.nn.silu(x).astype(jnp.float32))
    t = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    assert np.array_equal(xla_bf16_silu(t).float().numpy(), want)
    assert np.mean(torch.nn.functional.silu(t).float().numpy() != want) > 0.1


def hybrid_cfgs(dtype):
    jcfg = jconfigs.get_smoke("zamba2_2p7b").replace(param_dtype=dtype)
    cfg = configs.get_smoke("zamba2_2p7b").replace(param_dtype=dtype)
    return jcfg, cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_prefill_and_decode_steps_vs_jax(dtype, monkeypatch):
    """zamba2 at smoke size: prefill, then five decode steps, against the
    JAX package with the same params; the logits and every cache leaf
    (conv tails, SSM states, the shared block's KV per group).  fp32
    tight.  bf16 within 2e-2 of the logits' span and of each cache leaf's
    largest value, with the port's silu rounded op by op as XLA rounds
    ``jax.nn.silu`` (``xla_bf16_silu``; read 1.7e-2 at most, 4-5e-2
    with ``F.silu``, which rounds once: the Mamba2 block applies silu
    twice a layer and the stack carries the differences on).  The port's
    own bf16 rounding is held in ``test_hybrid_bf16_rounding_noise_vs_jax``."""
    if dtype == "bfloat16":
        monkeypatch.setattr(torch.nn.functional, "silu", xla_bf16_silu)
    jcfg, cfg = hybrid_cfgs(dtype)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(8))
    tp = interop.params_from_numpy(np_tree(jp), "cpu")
    rng = np.random.default_rng(9)
    B, P, smax = 2, 21, 32
    prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    jcache = jmodel.init_cache(jcfg, B, smax)
    cache = model.init_cache(cfg, B, smax, "cpu")
    wl, jcache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                jcache)
    gl, cache = model.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                              cache)
    span = float(np.abs(np.asarray(wl, np.float32)).max())
    rel = 1e-4 if dtype == "float32" else 2e-2
    lt = dict(atol=rel * span, rtol=rel)

    def check_cache():
        jleaves = dict(flatten(jax.tree.map(np.asarray, jcache)))
        leaves = dict(flatten(cache))
        assert sorted(jleaves) == sorted(leaves) == [
            "attn/k", "attn/v", "mamba/conv", "mamba/ssm"]
        for k, v in leaves.items():
            want = np.asarray(jleaves[k], np.float32)
            assert tuple(v.shape) == want.shape, k
            assert_close(v, want, atol=rel * float(np.abs(want).max()),
                         rtol=rel)

    assert_close(gl, wl, **lt)
    check_cache()
    tok = np.argmax(np.asarray(wl, np.float32), -1).astype(np.int32)[:, None]
    for i in range(5):
        n = P + i
        wl, jcache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                        jnp.int32(n))
        gl, cache = model.decode_step(tp, cfg, torch.from_numpy(tok), cache,
                                      torch.tensor(n, dtype=torch.int32))
        assert_close(gl, wl, **lt)
        check_cache()
        tok = np.argmax(np.asarray(wl, np.float32),
                        -1).astype(np.int32)[:, None]


def test_hybrid_bf16_rounding_noise_vs_jax():
    """The port's own bf16 path (``F.silu``, rounding once) against the
    reference's fp32 logits of the same (upcast) weights: no farther from
    them than the reference's bf16 logits are (read: 3.2e-2 and 5.9e-2 of
    the span), which lie farther than 2e-2 of the span from them."""
    jcfg, cfg = hybrid_cfgs("bfloat16")
    jcfg32 = jcfg.replace(param_dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(8))
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    tp = interop.params_from_numpy(np_tree(jp), "cpu")
    rng = np.random.default_rng(9)
    B, P, smax = 2, 21, 32
    prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    ref, _ = jmodel.prefill(jp32, jcfg32, {"tokens": jnp.asarray(prompt)},
                            jmodel.init_cache(jcfg32, B, smax))
    jl, _ = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                           jmodel.init_cache(jcfg, B, smax))
    tl, _ = model.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                          model.init_cache(cfg, B, smax, "cpu"))
    ref = np.asarray(ref, np.float32)
    span = float(np.abs(ref).max())
    jax_noise = float(np.abs(np.asarray(jl, np.float32) - ref).max())
    port_noise = float(np.abs(tl.float().numpy() - ref).max())
    assert jax_noise > 2e-2 * span
    assert port_noise <= jax_noise


def test_hybrid_decode_consistency():
    """Prefill + token-by-token decode == one full causal forward (the
    port alone, fp32), as the reference's ``test_decode_consistency``."""
    _, cfg = hybrid_cfgs("float32")
    params = model.init_params(cfg, seed=10, device="cpu")
    rng = np.random.default_rng(11)
    B, S = 2, 24
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    x = model.embed_inputs(params, cfg, {"tokens": tokens})
    with torch.no_grad():
        full, _, _ = model.forward(params, cfg, x,
                                   positions=torch.arange(S))
    P = S - 3
    cache = model.init_cache(cfg, B, S + 4, "cpu")
    last, cache = model.prefill(params, cfg, {"tokens": tokens[:, :P]},
                                cache)
    np.testing.assert_allclose(last.numpy(), full[:, P - 1].numpy(),
                               atol=1e-4, rtol=1e-4)
    for i in range(S - P):
        logits, cache = model.decode_step(
            params, cfg, tokens[:, P + i:P + i + 1], cache,
            torch.tensor(P + i, dtype=torch.int32))
        np.testing.assert_allclose(logits.numpy(), full[:, P + i].numpy(),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ["deepseek_7b", "zamba2_2p7b"])
def test_decode_step_with_a_device_position_vs_jax(arch):
    """``model.decode_step`` takes ``cache_len`` as a 0-d int32 tensor, as
    the reference does (a captured step reads it at every replay): the
    dense and hybrid smoke configs in fp32, prefill and then four decode
    steps at positions P..P+3, each step's logits within 1e-5 of their
    range of the reference's ``decode_step`` fed ``jnp.int32``, and the
    cache leaf by leaf within 1e-5 of each leaf's largest value."""
    jcfg = jconfigs.get_smoke(arch).replace(param_dtype="float32")
    cfg = configs.get_smoke(arch).replace(param_dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(14))
    tp = interop.params_from_numpy(np_tree(jp), "cpu")
    rng = np.random.default_rng(15)
    B, P, smax = 2, 11, 16
    prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    jcache = jmodel.init_cache(jcfg, B, smax)
    cache = model.init_cache(cfg, B, smax, "cpu")
    wl, jcache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                jcache)
    _, cache = model.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                             cache)
    for i in range(4):
        tok = np.argmax(np.asarray(wl), -1).astype(np.int32)[:, None]
        pos = torch.tensor(P + i, dtype=torch.int32)
        assert pos.ndim == 0
        wl, jcache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                        jnp.int32(P + i))
        gl, cache = model.decode_step(tp, cfg, torch.from_numpy(tok), cache,
                                      pos)
        want = np.asarray(wl, np.float32)
        span = float(want.max() - want.min())
        assert_close(gl, want, atol=1e-5 * span, rtol=0)
        jleaves = dict(flatten(jax.tree.map(np.asarray, jcache)))
        for k, v in flatten(cache):
            w = np.asarray(jleaves[k], np.float32)
            assert_close(v, w, atol=1e-5 * float(np.abs(w).max()), rtol=0)


# ------------------------------------------------- the other dense configs

OTHER_DENSE = ["mistral_nemo_12b", "starcoder2_15b", "yi_34b"]


@pytest.mark.parametrize("arch", OTHER_DENSE)
def test_other_dense_smoke_configs_vs_jax(arch):
    """The three dense configs besides deepseek_7b at ``get_smoke`` size
    in fp32: prefill and three decode steps, the loss and every leaf's
    gradient against the JAX package from the same params and batch.
    starcoder2_15b is the one config with LayerNorm and a non-gated
    tanh-GELU MLP.  Logits within 1e-5 of their range (XLA:CPU and ATen
    sum the matmuls in different orders; 8.3e-7 measured), the loss at
    rtol 1e-5, gradients at atol 1e-5, rtol 1e-4 (1.6e-6 measured)."""
    import dataclasses
    from repro_torch.data import pipeline
    from repro_torch.models.config import ShapeConfig
    from repro_torch.train import optimizer, train_step
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch),
                               param_dtype="float32")
    cfg = dataclasses.replace(configs.get_smoke(arch), param_dtype="float32")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(11))
    tp = interop.params_from_numpy(np_tree(jp), "cpu")
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jcache = jmodel.init_cache(jcfg, 2, 16)
    cache = model.init_cache(cfg, 2, 16, "cpu")
    wl, jcache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                jcache)
    gl, cache = model.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                              cache)
    for i in range(4):
        want = np.asarray(wl, np.float32)
        span = float(np.abs(want).max())
        assert_close(gl, want, atol=1e-5 * span, rtol=0)
        if i == 3:
            break
        tok = np.argmax(want, -1).astype(np.int32)[:, None]
        n = prompt.shape[1] + i
        wl, jcache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                        jnp.int32(n))
        gl, cache = model.decode_step(tp, cfg, torch.from_numpy(tok), cache,
                                      torch.tensor(n, dtype=torch.int32))

    nb = pipeline.synthetic_batch(cfg, ShapeConfig("t", "train", 12, 2),
                                  step=0, seed=13)
    want_l, want_g = jax.value_and_grad(lambda p: jmodel.loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in nb.items()})[0])(jp)
    state = train_step.make_train_state(
        cfg, 0, optimizer.OptConfig(),
        params=interop.params_from_numpy(np_tree(jp), "cpu"), device="cpu")
    got_l, got_g = train_step.value_and_grad(
        state["params"], cfg, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    want_flat = dict(flatten(np_tree(want_g)))
    got_flat = dict(flatten(got_g))
    assert set(got_flat) == set(want_flat)
    for path, g in got_flat.items():
        np.testing.assert_allclose(g.numpy(), want_flat[path], err_msg=path,
                                   atol=1e-5, rtol=1e-4)
