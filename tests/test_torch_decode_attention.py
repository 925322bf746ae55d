"""Dense-cache decode attention (``kernels.ops.decode_attention`` and
``kernels/decode_attention.py``) on the CPU, against the JAX package's
``repro.kernels.ops.decode_attention`` (plain jnp, not a TPU kernel) and
against the port's own whole softmax.

Held:
  - the plain version on the strided view ``models/layers.py`` hands over
    (a (B, Smax, Hkv, D) buffer seen as (B, Hkv, Smax, D)) against the
    reference within rtol 1e-6 and atol 2e-6 (ATen and XLA sum the
    80-long dot products in different orders: 1.21e-6 at most, read at
    G = 7, D = 80), at groups G = 1, 4, 5, 7 and 12, head dims 16 and 80,
    cache_len 1, mid-cache and Smax, with no window and a window shorter
    than cache_len: fp32, bf16 caches with an fp32 q (the output fp32),
    and all bf16, whose bf16 output is held within one bf16 step (2^-7
    relative at most: the two fp32 results a last bit apart can round to
    neighbouring bf16 values);
  - the kernel's partition-and-merge arithmetic
    (``decode_attention_split_torch``) against the plain whole softmax
    within rtol 1e-5 on the fp32 (o, lse), at the plan's own n_split and
    at others, at cache_len on a span boundary and one past it, with
    windows and offsets, and a
    slice with no valid position: its lse NEG_INF, its o finite, its
    weight 0 in ``merge_attention``;
  - ``partials=True`` then the cast is ``partials=False`` bit for bit;
  - ``impl="kernel"`` and the kernel's wrapper on CPU tensors raise;
  - the fake path: one ``decode_attention`` a layer on a fake decode step,
    its FLOPs and bytes the kernel's (every K/V row it reads once).

Each distance is |got - want| <= rtol * (|want| + rms(want)), element by
element, as ``chip_smoke.close`` measures the kernel on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

B, HKV, SMAX = 2, 2, 40


def held(got, want, rtol, what=""):
    g = got.detach().float()
    w = want.detach().float()
    rms = float(w.pow(2).mean().sqrt())
    tol = rtol * (w.abs() + rms)
    bad = ((g - w).abs() > tol) | ~torch.isfinite(g)
    assert not bool(bad.any()), (
        f"{what}: max abs err {float((g - w).abs().max())}, worst "
        f"{float(((g - w).abs() / tol.clamp_min(1e-30)).max())} x tol")


def inputs(G, D, Dv=None, *, seed=0, smax=SMAX, b=B, hkv=HKV,
           q_dtype=torch.float32, cache_dtype=torch.float32):
    """q (b, G hkv, 1, D) and the caches as ``layers.py`` hands them
    over: transposed views of (b, smax, hkv, D | Dv) buffers."""
    Dv = Dv or D
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, G * hkv, 1, D),
                                             dtype=np.float32))
    k = torch.from_numpy(rng.standard_normal((b, smax, hkv, D),
                                             dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal((b, smax, hkv, Dv),
                                             dtype=np.float32))
    return (q.to(q_dtype), k.to(cache_dtype).transpose(1, 2),
            v.to(cache_dtype).transpose(1, 2))


def reference(q, k, v, cache_len, window):
    def j(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().contiguous().numpy()).astype(
                jnp.bfloat16)
        return jnp.asarray(t.contiguous().numpy())
    out = jops.decode_attention(j(q), j(k), j(v), jnp.int32(cache_len),
                                sliding_window=window)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


DTYPES = {"f32": (torch.float32, torch.float32),
          "bf16_cache": (torch.float32, torch.bfloat16),
          "bf16": (torch.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("D", [16, 80])
@pytest.mark.parametrize("G", [1, 4, 5, 7, 12])
def test_plain_on_the_strided_view_is_the_reference(G, D, dtypes):
    q_dtype, cache_dtype = DTYPES[dtypes]
    q, k, v = inputs(G, D, seed=G * 100 + D, q_dtype=q_dtype,
                     cache_dtype=cache_dtype)
    assert not k.is_contiguous()
    for cache_len in (1, SMAX // 2 + 3, SMAX):
        for window in (0, cache_len // 3):
            if window and window >= cache_len:
                continue
            got = ops.decode_attention(q, k, v, torch.tensor(cache_len),
                                       sliding_window=window)
            assert got.dtype == q_dtype and got.shape == (B, G * HKV, 1, D)
            want = reference(q, k, v, cache_len, window)
            if q_dtype == torch.bfloat16:
                np.testing.assert_allclose(got.float().numpy(),
                                           want.numpy(), rtol=2 ** -7,
                                           atol=1e-6)
            else:
                np.testing.assert_allclose(got.numpy(), want.numpy(),
                                           rtol=1e-6, atol=2e-6)


def whole(q, k, v, cache_len, window=0, offset=0):
    """The plain version in one chunk: the whole softmax's (o, lse)."""
    return da.decode_attention_torch(q, k, v, cache_len,
                                     sliding_window=window, offset=offset,
                                     chunk=k.shape[2], partials=True)


# (Smax, cache_len, window, n_split): n_split 0 the plan's own for the
# shapes, else that many blocks; cache_len on a 128-position span's
# boundary and one past it among them (spans are at least MIN_SPAN = 128
# positions, more where n_split blocks would take more)
SPLIT_CASES = [
    (300, 128, 0, 1), (300, 129, 0, 3), (300, 256, 0, 2),
    (300, 257, 0, 3), (300, 300, 0, 1), (300, 1, 0, 3),
    (300, 129, 50, 3), (1000, 257, 200, 2), (1000, 999, 0, 3),
    (300, 128, 0, 0), (300, 129, 0, 0), (300, 300, 0, 0), (300, 1, 0, 0),
    (300, 257, 70, 0), (40, 33, 9, 0), (1000, 999, 0, 0),
]


@pytest.mark.parametrize("smax,cache_len,window,n_split", SPLIT_CASES)
@pytest.mark.parametrize("G", [1, 5])
def test_split_arithmetic_is_the_whole_softmax(smax, cache_len, window,
                                               n_split, G):
    q, k, v = inputs(G, 16, seed=smax + cache_len + n_split, smax=smax)
    n_split = n_split or da.split_plan(B, HKV, G, smax)
    spans = da.plan_spans(*da.valid_span(cache_len, 0, window, smax),
                          n_split)
    assert len(spans) <= n_split and spans, spans
    assert spans[-1][2] == cache_len
    o, lse = da.decode_attention_split_torch(
        q, k, v, torch.tensor(cache_len), sliding_window=window,
        n_split=n_split, partials=True)
    wo, wl = whole(q, k, v, cache_len, window)
    held(o, wo, 1e-5, "o")
    held(lse, wl, 1e-5, "lse")


@pytest.mark.parametrize("width", [75, 300])
def test_split_slices_with_offsets_merge_to_the_whole(width):
    """Four slices of ``width`` positions, each at its offset, as the data
    ranks of a sequence-split cache hold them: a slice past cache_len has
    lse NEG_INF, a finite o and weight 0; the merge is the whole
    softmax."""
    smax, n = 4 * width, width + 56
    q, k, v = inputs(4, 16, seed=7, smax=smax)
    wo, wl = whole(q, k, v, n)
    parts = []
    for lo in range(0, smax, width):
        ks, vs = k[:, :, lo:lo + width], v[:, :, lo:lo + width]
        o, lse = da.decode_attention_split_torch(
            q, ks, vs, n, offset=torch.tensor(lo),
            n_split=da.split_plan(B, HKV, 4, width), partials=True)
        if lo >= n:
            assert bool((lse == da.NEG_INF).all())
            assert bool(torch.isfinite(o).all())
            # the plain version's empty slice: lse NEG_INF too
            po, pl = whole(q, ks, vs, n, offset=lo)
            assert bool((pl == da.NEG_INF).all())
            assert bool(torch.isfinite(po).all())
        parts.append((o, lse))
    o, lse = ops.merge_attention(torch.stack([p[0] for p in parts]),
                                 torch.stack([p[1] for p in parts]))
    held(o, wo, 1e-5, "o")
    held(lse, wl, 1e-5, "lse")
    # the empty slices take weight 0: the live slices alone merge the same
    live = ops.merge_attention(torch.stack([p[0] for p in parts[:2]]),
                               torch.stack([p[1] for p in parts[:2]]))
    assert torch.equal(live[0], o) and torch.equal(live[1], lse)


def test_split_with_no_valid_position():
    """A slice wholly past cache_len, or wholly before a window's start:
    o = 0, lse = NEG_INF, nothing read."""
    q, k, v = inputs(4, 16, seed=3)
    for kw in (dict(offset=50), dict(offset=0, sliding_window=5)):
        cl = 40 if kw["offset"] else 0
        o, lse = da.decode_attention_split_torch(
            q, k, v, cl, n_split=4, partials=True, **kw)
        assert bool((o == 0).all()) and bool((lse == da.NEG_INF).all())


@pytest.mark.parametrize("window", [0, 7])
def test_partials_then_the_cast_is_the_cast(window):
    """``partials=True``, the one part's merge and the cast give
    ``partials=False``'s bits (the unsharded path against the
    sequence-split one at one data rank), plain and split versions."""
    q, k, v = inputs(5, 16, seed=11, q_dtype=torch.bfloat16,
                     cache_dtype=torch.bfloat16)
    B_, Hq, _, Dv = q.shape[0], q.shape[1], 1, v.shape[-1]
    for fn, kw in ((ops.decode_attention, dict(impl="torch")),
                   (ops.decode_attention, dict(impl="torch", chunk=8)),
                   (da.decode_attention_split_torch, dict(n_split=3)),
                   (da.decode_attention_split_torch, dict(n_split=1))):
        one = fn(q, k, v, torch.tensor(29), sliding_window=window, **kw)
        o, lse = fn(q, k, v, torch.tensor(29), sliding_window=window,
                    partials=True, **kw)
        o, _ = ops.merge_attention(o[None], lse[None])
        cast = o.reshape(B_, Hq, 1, Dv).to(q.dtype)
        assert torch.equal(cast.view(torch.int16), one.view(torch.int16))


def test_the_kernel_refuses_cpu_tensors():
    q, k, v = inputs(1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, k, v, 5, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(q, k, v, 5)
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(q, k, v, 5, impl="pallas")


def test_plans_follow_the_shapes():
    """The plan's blocks a (slot, kv head) from the shapes alone
    (~TARGET_BLOCKS a call, at most one a MIN_SPAN of the cache); the
    head chunk the group up to 12."""
    assert da.split_plan(1, 32, 1, 524288) == 33
    assert da.split_plan(4, 32, 1, 544) == 5
    assert da.split_plan(4, 8, 4, 2080) == 17
    assert da.split_plan(1, 1, 1, 300) == 3
    assert [da.head_chunk(g) for g in (1, 4, 5, 7, 12, 16, 13, 24)] == [
        1, 4, 5, 7, 12, 8, 1, 12]
    # the spans cover [lo, hi) once, in order
    for lo, hi, n in ((0, 32784, 33), (5, 1000, 9), (100, 32784, 4096),
                      (0, 1, 33)):
        spans = da.plan_spans(lo, hi, n)
        assert spans[0][1] == lo and spans[-1][2] == hi
        assert all(a[2] == b[1] for a, b in zip(spans, spans[1:]))
        assert len(spans) <= n


def test_fake_decode_step_counts_the_kernel(monkeypatch):
    """A decode step of the smoke deepseek_7b on fake tensors: one
    ``decode_attention`` a layer, never the plain version, charged 2 (D +
    Dv) FLOPs a (query head, position) and every K/V row of the Smax
    positions read once (a fake cache_len carries no value), q read and
    o written once; an int cache_len and offset count the valid
    positions."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import repro_torch.configs as configs
    from repro_torch.models import model

    def boom(*a, **k):
        raise AssertionError("the plain decode attention or the kernel ran")
    for n in ("decode_attention_torch", "decode_attention_cuda"):
        monkeypatch.setattr(da, n, boom)
    seen = []
    real = ops._cost
    monkeypatch.setattr(ops, "_cost", lambda name, f, b: (
        seen.append((name, f, b)), real(name, f, b)))
    cfg = configs.get_smoke("deepseek_7b")
    a = cfg.attention
    Bt, smax = 2, 24
    ops.reset_fake_cost()
    with FakeTensorMode():
        params = model.init_params(cfg, device="cpu")
        cache = model.init_cache(cfg, Bt, smax, "cpu")
        tok = torch.zeros((Bt, 1), dtype=torch.int64)
        logits, _ = model.decode_step(params, cfg, tok, cache, 7)
        assert logits.shape == (Bt, cfg.vocab_size)
    calls = ops.FAKE_COST["calls"]
    assert calls["decode_attention"] == cfg.n_layers
    D, Hq, Hkv = a.head_dim, a.n_heads, a.n_kv_heads
    want_f = Bt * Hq * smax * 2 * (D + D)
    want_b = (2 * 2 * Bt * Hq * D             # q read, o written (bf16)
              + Bt * smax * Hkv * (D + D) * 2)
    dec = [(f, b) for name, f, b in seen if name == "decode_attention"]
    assert dec == [(want_f, want_b)] * cfg.n_layers
    # an int cache_len (and offset) counts the valid positions only
    ops.reset_fake_cost()
    with FakeTensorMode():
        q = torch.empty(1, 8, 1, 16, dtype=torch.bfloat16)
        k = torch.empty(1, 100, 2, 16, dtype=torch.bfloat16).transpose(1, 2)
        o, lse = ops.decode_attention(q, k, k, 70, offset=50,
                                      sliding_window=15, partials=True)
        assert o.shape == (1, 2, 4, 16) and o.dtype == torch.float32
        assert lse.shape == (1, 2, 4)
    n = 15                                    # positions 55 .. 69
    assert seen[-1] == ("decode_attention", 8 * n * 2 * 32,
                        2 * 8 * 16 + 4 * (8 * 16 + 8) + n * 2 * 32 * 2)
