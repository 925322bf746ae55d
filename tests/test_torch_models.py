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
from repro.models.config import AttentionConfig as JAttn  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import layers, model  # noqa: E402
from repro_torch.models.config import AttentionConfig, ModelConfig  # noqa: E402
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

@pytest.mark.parametrize("which", ["tiny_f32", "deepseek_7b_smoke_bf16"])
def test_params_roundtrip_and_layout(which):
    """JAX params -> port -> numpy is bit-exact leaf for leaf, and the
    port's own init draws the same tree of shapes and dtypes."""
    if which == "tiny_f32":
        jcfg, cfg = tiny_cfgs()
    else:
        jcfg, cfg = (jconfigs.get_smoke("deepseek_7b"),
                     configs.get_smoke("deepseek_7b"))
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
    got, gc = layers.attention_fwd(tattn, torch.from_numpy(x), a,
                                   positions=torch.from_numpy(pos),
                                   cache=cache, cache_len=cache_len)
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
                                      n)
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


def test_unported_families_raise():
    for arch in ("deepseek_v2_236b", "xlstm_350m", "zamba2_2p7b"):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            configs.get(arch)
    with pytest.raises(KeyError):
        configs.get("no_such_arch")
    assert configs.get("deepseek_7b").d_model == 4096
