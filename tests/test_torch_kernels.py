"""The port's kernels, through their plain PyTorch versions, against the
JAX package: the chunked jnp paths of ``repro.kernels.ops``, the Pallas
kernels in interpret mode and the naive oracles.  Inputs are made from a
seed with numpy and handed to both frameworks.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each against the plain version tested here.  The backward kernels' plain
versions are held against JAX's gradients: ``jax.grad`` through the custom
VJP of ``ops._flash_jnp`` and through ``ops.rmsnorm``.

Tolerances: fp32 ``atol=1e-5, rtol=1e-4`` (XLA:CPU and ATen sum in
different orders); bf16 ``atol=rtol=2e-2`` (one bf16 rounding of the
output is 2^-8 relative, and the two frameworks may round intermediate
fp32 sums to different neighbours).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.paged_attention import paged_attention_pallas  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_pallas  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_pallas  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import quantized_state as jqs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_bwd_torch, flash_attention_cuda,
    flash_attention_torch)
from repro_torch.kernels.fused_adamw import (  # noqa: E402
    fused_adamw_cuda, fused_adamw_torch, vector_route)
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention_cuda, paged_attention_split_torch, paged_attention_torch,
    partition_pages, split_route)
from repro_torch.train import quantized_state as tqs  # noqa: E402
from repro_torch.kernels import rmsnorm as trn  # noqa: E402
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    bwd_vector_route, fwd_route, rmsnorm_bwd_cuda, rmsnorm_bwd_torch,
    rmsnorm_cuda, rmsnorm_torch, row_stride)
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    chunked_route, ssd_scan_bwd_cuda, ssd_scan_bwd_torch, ssd_scan_cuda,
    ssd_scan_passes_torch, ssd_scan_torch)

torch.set_num_threads(1)   # several test workers share the host's cores

F32_TOL = dict(atol=1e-5, rtol=1e-4)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


def tol(dtype):
    return BF16_TOL if dtype == "bfloat16" else F32_TOL


def both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 by the same round-to-nearest-even cast on both sides)."""
    j = jnp.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dtype == "bfloat16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def close(got_t, want_j, dtype):
    np.testing.assert_allclose(got_t.float().numpy(),
                               np.asarray(want_j, np.float32), **tol(dtype))


# ---------------------------------------------------------------- attention

ATTN_CASES = [
    # (B, Hq, Hkv, Sq, Sk, D, Dv, causal, window, q_offset)
    (1, 2, 2, 16, 16, 16, 16, True, 0, 0),      # causal MHA
    (2, 4, 2, 48, 48, 32, 32, True, 0, 0),      # GQA
    (1, 4, 1, 33, 65, 16, 16, True, 0, 32),     # MQA, ragged Sk, q_offset
    (2, 2, 2, 32, 32, 16, 16, False, 0, 0),     # non-causal
    (1, 2, 2, 64, 64, 16, 16, True, 24, 0),     # sliding window
    (1, 2, 2, 40, 40, 16, 8, True, 0, 0),       # Dv != D
    (1, 2, 1, 24, 24, 16, 16, True, 0, -5),     # rows 0-4 fully masked
]


def attn_inputs(case, dtype, seed=0):
    B, Hq, Hkv, Sq, Sk, D, Dv = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Sk, Dv), dtype=np.float32)
    return both(q, dtype), both(k, dtype), both(v, dtype)


@pytest.mark.parametrize("case,dtype",
                         [(c, "float32") for c in ATTN_CASES]
                         + [(ATTN_CASES[i], "bfloat16") for i in (1, 4, 5)])
def test_flash_attention_torch_vs_jax(case, dtype):
    causal, window, q_offset = case[7:]
    (qj, qt), (kj, kt), (vj, vt) = attn_inputs(case, dtype)
    got = flash_attention_torch(qt, kt, vt, causal=causal,
                                sliding_window=window, q_offset=q_offset)
    assert got.dtype == qt.dtype and got.shape == case[:2] + (case[3],
                                                               case[6])
    want_jnp = jops.flash_attention(qj, kj, vj, causal=causal,
                                    sliding_window=window, q_offset=q_offset,
                                    kv_chunk=16, impl="jnp")
    close(got, want_jnp, dtype)
    want_pallas = flash_attention_pallas(qj, kj, vj, causal=causal,
                                         sliding_window=window,
                                         q_offset=q_offset, block_q=16,
                                         block_k=16, interpret=True)
    close(got, want_pallas, dtype)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_misaligned_copy_routes_off_the_tensor_cores():
    """chip_smoke.py times the flash kernels' CUDA-core route on a copy of
    q one element off 16-byte alignment (the tensor-core route's TMA loads
    need aligned rows, so the entry point falls to the CUDA-core kernels):
    the copy must be contiguous, equal to q and misaligned."""
    smoke = _chip_smoke()
    q = torch.randn(2, 4, 33, 128).to(torch.bfloat16)
    m = smoke.misaligned(q)
    assert m.is_contiguous() and m.shape == q.shape and torch.equal(m, q)
    assert m.data_ptr() % 16 != 0 and q.data_ptr() % 16 == 0


def test_flash_attention_fully_masked_rows_are_zero():
    """q_pos < 0 sees no key: the row ends with l = 0 and is divided by 1
    (the naive oracle gives NaN there; the rest must agree with it)."""
    case = ATTN_CASES[-1]
    (_, qt), (_, kt), (_, vt) = attn_inputs(case, "float32")
    got = ops.flash_attention(qt, kt, vt, causal=True, q_offset=-5,
                              impl="torch")
    assert torch.all(got[:, :, :5] == 0)
    want = ref.attention(qt, kt, vt, causal=True, q_offset=-5)
    assert torch.isnan(want[:, :, :5]).all()
    np.testing.assert_allclose(got[:, :, 5:].numpy(),
                               want[:, :, 5:].numpy(), **F32_TOL)


# ---------------------------------------------------------- flash backward

#: the tolerance of tests/test_kernels.py's custom-VJP test: the rule sums
#: kv chunks of 16 in a scan, the plain version each row at once
BWD_TOL = dict(atol=2e-4, rtol=2e-3)


def flash_grads_both(case, seed=5):
    """(torch inputs, the cotangent, the plain backward's grads, the
    kwargs)."""
    causal, window, q_offset = case[7:]
    kw = dict(causal=causal, sliding_window=window, q_offset=q_offset)
    (_, qt), (_, kt), (_, vt) = attn_inputs(case, "float32", seed=seed)
    rng = np.random.default_rng(seed + 1)
    ct = rng.standard_normal(case[:2] + (case[3], case[6]), dtype=np.float32)
    o, lse = flash_attention_torch(qt, kt, vt, with_lse=True, **kw)
    got = flash_attention_bwd_torch(qt, kt, vt, o, lse, torch.from_numpy(ct),
                                    **kw)
    return (qt, kt, vt), ct, got, kw


@pytest.mark.parametrize("case", ATTN_CASES[:-1])
def test_flash_attention_bwd_torch_vs_jax(case):
    """The plain backward against ``jax.grad`` through the custom VJP
    (``_flash_bwd_rule``), and the forward's lse against
    ``_flash_fwd_impl``'s.  (The last case's fully masked rows are NaN in
    the rule; the next test covers them.)"""
    (qt, kt, vt), ct, got, kw = flash_grads_both(case)
    qj, kj, vj = (jnp.asarray(t.numpy()) for t in (qt, kt, vt))
    args = (kw["causal"], kw["sliding_window"], None, kw["q_offset"], 16)

    def loss(q, k, v):
        return jnp.sum(jops._flash_jnp(q, k, v, *args) * ct)

    want = jax.grad(loss, argnums=(0, 1, 2))(qj, kj, vj)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BWD_TOL)
    _, lse = flash_attention_torch(qt, kt, vt, with_lse=True, **kw)
    want_lse = jops._flash_fwd_impl(qj, kj, vj, *args)[1]
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(lse.shape),
                               **F32_TOL)
    # ops.flash_attention's autograd runs exactly this backward
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out = ops.flash_attention(*leaves, impl="torch", **kw)
    (out * torch.from_numpy(ct)).sum().backward()
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


def test_flash_attention_bwd_fully_masked_rows_get_zero_gradient():
    """Rows that see no key have lse = -1e30 and get zero dq; every grad
    is finite and agrees with autograd through the plain forward."""
    case = ATTN_CASES[-1]
    (qt, kt, vt), ct, got, kw = flash_grads_both(case)
    _, lse = flash_attention_torch(qt, kt, vt, with_lse=True, **kw)
    assert torch.all(lse[:, :, :5] == -1e30)
    assert torch.all(got[0][:, :, :5] == 0)
    leaves = [t.clone().requires_grad_(True) for t in (qt, kt, vt)]
    out = flash_attention_torch(*leaves, **kw)
    want = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), leaves)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), **BWD_TOL)


def test_bf16_p_fails_the_chip_tolerance_and_a_hi_lo_split_holds_it():
    """Why the tensor-core flash kernels give P (and dS) to their products
    as two bf16 parts, hi = bf16(x) and lo = bf16(x - hi): dv = P^T dO
    with P rounded once to bf16 breaks chip_smoke.py's element-wise bf16
    check (rtol 2e-2) at a causal (1, 4, 1024, 128), because kv rows that
    few queries see carry weights near 1; hi + lo holds it.  fp32 plain
    PyTorch on the CPU, only P rounded."""
    close = _chip_smoke().close
    rng = np.random.default_rng(0)
    S, D = 1024, 128
    q, k, do = (torch.from_numpy(rng.standard_normal((1, 4, S, D),
                                                     dtype=np.float32))
                .bfloat16().float() for _ in range(3))
    mask = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(mask, q @ k.transpose(-1, -2) / D ** 0.5, -1e30)
    p = torch.softmax(s, -1)
    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()

    def dv(pp):
        return (pp.transpose(-1, -2) @ do).bfloat16()

    want = dv(p)
    _, ratio_bf16 = close(dv(hi), want, 2e-2)
    _, ratio_split = close(dv(hi + lo), want, 2e-2)
    assert ratio_bf16 > 1.0 and ratio_split < 0.5, (ratio_bf16, ratio_split)


def test_decode_attention_vs_jax():
    B, Hq, Hkv, S, D = 2, 4, 2, 24, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, Hq, 1, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.int32(17))
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), 17)
    close(got, want, "float32")


# ------------------------------------------------------------------ rmsnorm

@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 128), (1, 1, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_torch_vs_jax(shape, dtype):
    rng = np.random.default_rng(2)
    xj, xt = both(rng.standard_normal(shape, dtype=np.float32), dtype)
    sj, st = both(rng.standard_normal((shape[-1],), dtype=np.float32), dtype)
    got = rmsnorm_torch(xt, st)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    close(got, rmsnorm_pallas(xj, sj, interpret=True, block_rows=8), dtype)
    close(got, jref.rmsnorm(xj, sj), dtype)
    close(got, ref.rmsnorm(xt, st).float().numpy(), dtype)


@pytest.mark.parametrize("shape", [(4, 64), (3, 17, 128), (1, 1, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_bwd_torch_vs_jax(shape, dtype):
    """(dx, dscale) of the plain backward against ``jax.vjp`` of
    ``ops.rmsnorm``: both differentiate the same fp32 expression and cast
    the gradients to the inputs' dtype."""
    rng = np.random.default_rng(3)
    xj, xt = both(rng.standard_normal(shape, dtype=np.float32), dtype)
    sj, st = both(rng.standard_normal((shape[-1],), dtype=np.float32), dtype)
    gj, gt = both(rng.standard_normal(shape, dtype=np.float32), dtype)
    _, vjp = jax.vjp(lambda x, s: jops.rmsnorm(x, s, impl="jnp"), xj, sj)
    want = vjp(gj)
    got = rmsnorm_bwd_torch(xt, st, gt)
    for g, w, t in zip(got, want, (xt, st)):
        assert g.dtype == t.dtype and g.shape == t.shape
        close(g, w, dtype)


def test_rmsnorm_bwd_route_choice():
    """The backward's vector route takes rows of whole 16-byte words (d a
    multiple of 8 bf16 or 4 f32) on 16-byte aligned x, scale and g: every
    train-step norm of deepseek_7b (4096); the scalar route the rest, a
    copy one element off alignment among them (``chip_smoke.misaligned``)."""
    smoke = _chip_smoke()

    def route(rows, d, dtype=torch.bfloat16, misalign=False):
        x = torch.zeros(rows, d, dtype=dtype)
        g = smoke.misaligned(x) if misalign else x.clone()
        return bwd_vector_route(x, torch.ones(d, dtype=dtype), g)

    assert route(4096, 4096) and route(1, 64) and route(3, 8, torch.float32)
    assert route(2, 8192) and route(5, 2560)
    assert not route(5, 4100) and not route(3, 6, torch.float32)
    assert not route(6, 4096, misalign=True)


def test_rmsnorm_fwd_route_choice():
    """The forward's vector route takes rows of whole 16-byte words (d a
    multiple of 8 bf16 or 4 f32, up to 8192) at a row stride of whole
    16-byte words on 16-byte aligned x and scale: every main-path norm,
    MLA's kv_a[..., :512] slice of 576-wide rows among them; the scalar
    route the rest: odd widths, a copy one element off alignment
    (``chip_smoke.misaligned``), a stride of 4100 bf16."""
    smoke = _chip_smoke()

    def route(x):
        return fwd_route(x, torch.ones(x.shape[-1], dtype=x.dtype))

    def rows(n, d, dtype=torch.bfloat16):
        return torch.zeros(n, d, dtype=dtype)

    assert route(rows(4096, 4096)) == "vector"
    assert route(rows(1, 64)) == "vector"
    assert route(rows(3, 8, torch.float32)) == "vector"
    assert route(rows(2, 8192)) == "vector"
    kv_a = torch.zeros(2, 5, 576, dtype=torch.bfloat16)
    assert not kv_a[..., :512].is_contiguous()
    assert route(kv_a[..., :512]) == "vector"
    assert route(rows(5, 4100)) == "scalar"
    assert route(rows(3, 6, torch.float32)) == "scalar"
    assert route(smoke.misaligned(rows(6, 4096))) == "scalar"
    assert route(torch.zeros(6, 4100, dtype=torch.bfloat16)[:, :4096]) \
        == "scalar"


def test_rmsnorm_row_stride():
    """``row_stride``: the one stride between x's rows, in elements, where
    its leading dimensions collapse (size-1 dimensions skipped), else
    None."""
    x = torch.zeros(2, 5, 576)
    assert row_stride(x) == 576
    assert row_stride(x[..., :512]) == 576
    assert row_stride(x[:, -1:, :512]) == 5 * 576
    assert row_stride(x[:1, :, 64:]) == 576
    assert row_stride(torch.zeros(7)) == 7
    assert row_stride(x[:, 1:3]) is None          # 2 of 5 rows a batch
    assert row_stride(x.transpose(1, 2)) is None  # last dim not contiguous
    assert row_stride(torch.zeros(4, 1).expand(4, 3)) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_strided_slice_vs_contiguous_and_jax(dtype):
    """``ops.rmsnorm`` on a slice of wider rows (MLA's kv_a[..., :R]) gives
    the values it gives on the slice's contiguous copy, bit for bit, and
    the JAX ``ops.rmsnorm`` (``impl="jnp"``) on the same numpy input."""
    rng = np.random.default_rng(11)
    kv_a = rng.standard_normal((2, 7, 24), dtype=np.float32)
    scale = rng.standard_normal((16,), dtype=np.float32)
    _, xt = both(kv_a, dtype)
    sj, st = both(scale, dtype)
    xj, _ = both(np.ascontiguousarray(kv_a[..., :16]), dtype)
    view = xt[..., :16]
    assert not view.is_contiguous() and row_stride(view) == 24
    got = ops.rmsnorm(view, st)
    assert got.shape == (2, 7, 16) and got.dtype == xt.dtype
    assert torch.equal(got, ops.rmsnorm(view.contiguous(), st))
    close(got, jops.rmsnorm(xj, sj, impl="jnp"), dtype)


def test_rmsnorm_kernel_path_reads_strided_rows_in_place(monkeypatch):
    """With the kernel taken (its plain versions standing in on the CPU):
    without a gradient, a slice of wider rows reaches the forward kernel
    as the view itself and rows at no one stride as a contiguous copy;
    under autograd x reaches it contiguous, and the backward kernel reads
    that same saved x."""
    seen = {}

    def fwd(x, scale, eps=1e-6):
        seen.setdefault("fwd", []).append(x)
        return rmsnorm_torch(x, scale, eps)

    def bwd(x, scale, g, eps=1e-6):
        seen["bwd"] = x
        return rmsnorm_bwd_torch(x, scale, g, eps)

    monkeypatch.setattr(ops, "_use_kernel", lambda impl, x: True)
    monkeypatch.setattr(trn, "rmsnorm_cuda", fwd)
    monkeypatch.setattr(trn, "rmsnorm_bwd_cuda", bwd)
    kv_a = torch.randn(2, 5, 24)
    s = torch.randn(16)
    view = kv_a[..., :16]
    ops.rmsnorm(view, s)
    assert seen["fwd"][-1] is view
    gappy = kv_a[:, 1:3, :16]
    want = rmsnorm_torch(gappy, s)
    assert torch.equal(ops.rmsnorm(gappy, s), want)
    assert seen["fwd"][-1].is_contiguous()
    xg = view.clone().requires_grad_(True)
    sg = s.clone().requires_grad_(True)
    ops.rmsnorm(xg[..., :12], sg[:12]).sum().backward()
    saved = seen["fwd"][-1]
    assert saved.is_contiguous() and seen["bwd"] is saved
    wx, ws = torch.autograd.grad(rmsnorm_torch(
        xg[..., :12], sg[:12]).sum(), (xg, sg))
    torch.testing.assert_close(xg.grad, wx)
    torch.testing.assert_close(sg.grad, ws)


# ------------------------------------------------------------ fused AdamW

ADAM_LEAVES = [
    # (shape, param dtype): a stacked (n, d) leaf and a bf16 matrix with a
    # ragged last quant block (weight decay on), a 1-d leaf and a scalar
    # (weight decay off)
    ((4, 300), "float32"), ((3, 2, 600), "bfloat16"), ((300,), "float32"),
    ((), "float32")]


def adam_inputs(shape, dtype, bits, seed=7):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape, dtype=np.float32)
    g = rng.standard_normal(shape, dtype=np.float32)
    m = rng.standard_normal(shape, dtype=np.float32) * 0.1
    v = np.abs(rng.standard_normal(shape, dtype=np.float32)) * 0.01
    pj = jnp.asarray(p).astype(dtype)
    pt = torch.from_numpy(np.array(p)).to(getattr(torch, dtype))
    mj, vj = jnp.asarray(m), jnp.asarray(v)
    if bits == 8:
        mj, vj = jqs.quantize(mj), jqs.quantize(vj)
    to_t = lambda x: (  # noqa: E731
        {k: torch.from_numpy(np.array(a)) for k, a in x.items()}
        if isinstance(x, dict) else torch.from_numpy(np.array(x)))
    return (pj, jnp.asarray(g), mj, vj), (pt, torch.from_numpy(g), to_t(mj),
                                          to_t(vj))


def assert_same(got, want):
    """Bit for bit: the same fp32 op sequence, each op rounded once, on
    both sides (eager JAX fuses nothing into an FMA)."""
    if isinstance(want, dict):
        for k in want:
            assert_same(got[k], want[k])
        return
    w = np.asarray(want)
    g = got.float().numpy() if got.dtype == torch.bfloat16 else got.numpy()
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w.astype(g.dtype))


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("shape,dtype", ADAM_LEAVES)
def test_fused_adamw_torch_vs_jax(shape, dtype, bits):
    """The plain fused AdamW against ``optimizer._adam_leaf`` and
    ``ops._fused_adamw_jnp``, bit for bit, for fp32 and int8 moments; and
    ``ops.fused_adamw`` on CPU tensors writes the same values in place."""
    (pj, gj, mj, vj), (pt, gt, mt, vt) = adam_inputs(shape, dtype, bits)
    hyper = dict(lr=3e-4, scale=0.7, bc1=0.1, bc2=0.05)
    cfg = jopt.OptConfig(state_bits=bits)
    kw = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
              weight_decay=cfg.weight_decay, apply_wd=len(shape) >= 2)
    want = jopt._adam_leaf(cfg, *hyper.values(), pj, gj, mj, vj)
    want_jnp = jops._fused_adamw_jnp(pj, gj, mj, vj, **hyper, **kw)
    got = fused_adamw_torch(pt, gt, mt, vt, **hyper, **kw)
    for g, w, w2 in zip(got, want, want_jnp):
        assert_same(g, w)
        assert_same(g, w2)
    out = ops.fused_adamw(pt, gt, mt, vt, **hyper, **kw)
    assert out[0] is pt and out[1] is mt
    for g, w in zip(out, want):
        assert_same(g, w)


def _fma32(a, b, c):
    """fma(a, b, c) of float32 values with one rounding.  a * b is exact in
    float64; the float64 sum rounds once more, which can differ from one
    rounding only where it lands exactly on a float32 midpoint and was
    itself inexact (TwoSum finds those): these few are redone exactly."""
    from fractions import Fraction
    a, b, c = (np.asarray(x, np.float32).astype(np.float64)
               for x in (a, b, c))
    prod = a * b
    s = prod + c
    bb = s - prod
    err = (prod - (s - bb)) + (c - bb)          # TwoSum: s + err is exact
    out = s.astype(np.float32)
    mant = np.frexp(s)[0] * 2.0 ** 25
    redo = (err != 0) & (mant == np.floor(mant)) & (np.fmod(mant, 2) != 0)
    for i in np.flatnonzero(redo):
        exact = Fraction(prod[i]) + Fraction(c[i])
        cand = out[i]
        nbrs = [np.nextafter(cand, np.float32(-np.inf)), cand,
                np.nextafter(cand, np.float32(np.inf))]
        out[i] = min(nbrs, key=lambda f: (abs(Fraction(float(f)) - exact),
                                          int(np.float32(f).view(np.int32))
                                          & 1))
    return out


def reciprocal_quotient(x, b):
    """The vector route's x / b for a divisor constant over a launch or a
    quant block (``csrc/fused_adamw.cu`` ``markstein``): y = RN(1/b),
    q = RN(x y), t = fma(q, b, -x), q' = fma(-t, y, q)."""
    y = np.float32(1.0) / b
    q = x * y
    t = _fma32(q, b, -x)
    return _fma32(-t, y, q)


def test_reciprocal_fma_quotient_is_ieee_division():
    """Markstein's quotient equals IEEE float32 division, bit for bit, on
    seeded pairs over the moments' range (1e-12 to 1e2, both signs, and
    zeros of both signs) and the divisors the kernel sees: bias
    corrections 1 - b^t in (0, 1], block scales amax / 127, and
    mantissas of all ones."""
    rng = np.random.default_rng(0)
    n = 300_000
    x = (10.0 ** rng.uniform(-12, 2, n)
         * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    x[:64] = np.float32(0.0)
    x[64:128] = np.float32(-0.0)
    b1 = rng.choice([0.9, 0.95, 0.999], n // 4)
    t = rng.integers(1, 10_000, n // 4)
    ones = np.float32(2.0 - 2.0 ** -23) * np.float32(2.0) ** rng.integers(
        -40, 1, n // 4).astype(np.float32)
    b = np.concatenate([
        1.0 - b1 ** t, rng.uniform(1e-7, 1.0, n // 4),
        (10.0 ** rng.uniform(-12, 2, n - 3 * (n // 4))) / np.float32(127),
        ones]).astype(np.float32)
    b = b[rng.permutation(n)]
    got = reciprocal_quotient(x, b)
    want = x / b
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _aligned_leaf(shape, quant, dtype=torch.bfloat16):
    p = torch.zeros(shape, dtype=dtype)
    if quant:
        return p, p.clone(), tqs.zeros_like_quantized(p), \
            tqs.zeros_like_quantized(p)
    return p, p.clone(), p.float(), p.float()


@pytest.mark.parametrize("quant", [False, True])
def test_fused_adamw_route_choice(quant):
    """The vector route takes a last dim that is a multiple of 16 on 16-byte
    aligned buffers (every deepseek_7b leaf but the scalar one, ragged
    quant blocks included); the scalar route takes the rest, a p one
    element off alignment among them (``chip_smoke.misaligned``)."""
    smoke = _chip_smoke()
    for shape in ((3, 4096), (2, 3, 11008), (4096,), (3, 4112)):
        assert vector_route(*_aligned_leaf(shape, quant)), shape
    for shape in ((7, 300), (3, 1000), ()):
        assert not vector_route(*_aligned_leaf(shape, quant)), shape
    p, g, m, v = _aligned_leaf((5, 4096), quant)
    assert not vector_route(smoke.misaligned(p), g, m, v)


# ------------------------------------------------------------ paged attention

def make_paged(B, Hq, Hkv, D, Dv, page, maxp, n_pages, lens, seed=3):
    """Random pool + per-slot tables; page 0 is the (garbage) trash page and
    unallocated table entries point at it."""
    rng = np.random.default_rng(seed)
    k_pages = rng.standard_normal((n_pages, page, Hkv, D), dtype=np.float32)
    v_pages = rng.standard_normal((n_pages, page, Hkv, Dv), dtype=np.float32)
    q = rng.standard_normal((B, Hq, D), dtype=np.float32)
    free = list(rng.permutation(np.arange(1, n_pages)))
    table = np.zeros((B, maxp), np.int32)
    for b, ln in enumerate(lens):
        for j in range((ln + page - 1) // page):
            table[b, j] = free.pop()
    return q, k_pages, v_pages, table, np.asarray(lens, np.int32)


def paged_both(q, k_pages, v_pages, table, lens, dtype):
    """torch plain version vs JAX's jnp path and Pallas kernel."""
    (qj, qt), (kj, kt), (vj, vt) = (both(x, dtype)
                                     for x in (q, k_pages, v_pages))
    got = paged_attention_torch(qt, kt, vt, torch.from_numpy(table),
                                torch.from_numpy(lens))
    tj, lj = jnp.asarray(table), jnp.asarray(lens)
    want_jnp = jops.paged_attention(qj[:, :, None], kj, vj, tj, lj,
                                    impl="jnp")[:, :, 0]
    want_pallas = paged_attention_pallas(qj, kj, vj, tj, lj, interpret=True)
    return got, want_jnp, want_pallas


@pytest.mark.parametrize("B,Hq,Hkv,D,Dv,page,maxp",
                         [(3, 4, 2, 16, 16, 8, 2),    # GQA
                          (2, 4, 1, 16, 8, 4, 4),     # MQA, Dv != D
                          (2, 24, 2, 16, 16, 4, 3),   # G = 12 (starcoder2)
                          (1, 2, 2, 8, 8, 16, 1)])    # MHA, single page
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_torch_vs_jax_full_slots(B, Hq, Hkv, D, Dv, page,
                                                 maxp, dtype):
    lens = [page * maxp] * B
    args = make_paged(B, Hq, Hkv, D, Dv, page, maxp, B * maxp + 2, lens)
    got, want_jnp, want_pallas = paged_both(*args, dtype)
    assert got.shape == (B, Hq, Dv) and got.dtype == (
        torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    close(got, want_jnp, dtype)
    close(got, want_pallas, dtype)


def test_paged_attention_ragged_lens_and_poisoned_trash_page():
    """Ragged fills (1 token, mid-page, page boundary, full) with the trash
    page poisoned: rows past ``seq_lens`` must not leak in, and the result
    stays finite."""
    B, Hq, Hkv, D, page, maxp = 4, 4, 2, 16, 4, 3
    q, k_pages, v_pages, table, lens = make_paged(
        B, Hq, Hkv, D, D, page, maxp, B * maxp + 1, [1, 5, 8, 12], seed=4)
    k_pages[0], v_pages[0] = 1e4, -1e4
    got, want_jnp, want_pallas = paged_both(q, k_pages, v_pages, table, lens,
                                            "float32")
    assert torch.isfinite(got).all()
    close(got, want_jnp, "float32")
    close(got, want_pallas, "float32")
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k_pages, v_pages))
    for b, ln in enumerate(lens):              # vs the truncated oracle
        kd = kt[torch.from_numpy(table[b]).long()].reshape(1, -1, Hkv, D)
        vd = vt[torch.from_numpy(table[b]).long()].reshape(1, -1, Hkv, D)
        w = ref.attention(qt[b:b + 1, :, None], kd[:, :ln].transpose(1, 2),
                          vd[:, :ln].transpose(1, 2), causal=False)
        np.testing.assert_allclose(got[b:b + 1].numpy(), w[:, :, 0].numpy(),
                                   **F32_TOL)


def test_paged_attention_empty_slot_is_zero():
    """``seq_lens[b] == 0``: nothing to attend to, l = 0 is divided by 1 and
    the slot's output is 0 (the CUDA kernel's convention; the model never
    asks for it, since a decode step attends over ``seq_lens + 1``)."""
    q, k_pages, v_pages, table, lens = make_paged(2, 2, 1, 8, 8, 4, 2, 6,
                                                  [0, 6], seed=5)
    got = paged_attention_torch(*(torch.from_numpy(x) for x in
                                  (q, k_pages, v_pages, table, lens)))
    assert torch.all(got[0] == 0) and torch.isfinite(got).all()


# the split route's partition-and-merge arithmetic: lengths on and across
# 16- and 128-position partition boundaries, an empty slot, one position
SPLIT_CASES = [
    # (B, Hq, Hkv, D, Dv, page, maxp, lens)
    (8, 24, 2, 16, 8, 4, 40, [0, 1, 16, 17, 127, 128, 129, 160]),  # G = 12
    (4, 8, 2, 32, 32, 8, 20, [33, 96, 150, 160]),                   # GQA 4
]


@pytest.mark.parametrize("part", [16, 128])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_paged_attention_split_torch_vs_plain_and_pallas(case, part):
    """``paged_attention_split_torch`` (partials per partition of ``part``
    positions, merged in order) against ``paged_attention_torch`` and the
    Pallas kernel in interpret mode, fp32, within 1e-5: the merge only
    reorders sums.  An empty slot is 0, as in the plain version (the Pallas
    kernel averages every row there)."""
    B, Hq, Hkv, D, Dv, page, maxp, lens = case
    q, k_pages, v_pages, table, lens = make_paged(
        B, Hq, Hkv, D, Dv, page, maxp, B * maxp + 1, lens, seed=6)
    k_pages[0], v_pages[0] = 1e4, -1e4          # the trash page, poisoned
    args = [torch.from_numpy(x) for x in (q, k_pages, v_pages, table, lens)]
    got = paged_attention_split_torch(*args, part=part)
    plain = paged_attention_torch(*args)
    want_pallas = np.asarray(paged_attention_pallas(
        *(jnp.asarray(x) for x in (q, k_pages, v_pages, table, lens)),
        interpret=True))
    assert got.shape == (B, Hq, Dv) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=1e-5)
    live = lens > 0
    np.testing.assert_allclose(got.numpy()[live], want_pallas[live],
                               atol=1e-5, rtol=1e-5)
    assert torch.all(got[~torch.from_numpy(live)] == 0)


def test_paged_split_route_choice():
    """The split route takes head dims that are whole 16-byte words (8 bf16,
    4 f32) on 16-byte aligned q and pools; a partition is ~128 positions
    of whole pages."""
    smoke = _chip_smoke()

    def route(D, Dv, dtype, misalign=False):
        q = torch.zeros(2, 4, D, dtype=dtype)
        k = torch.zeros(5, 16, 2, D, dtype=dtype)
        v = torch.zeros(5, 16, 2, Dv, dtype=dtype)
        return split_route(smoke.misaligned(q) if misalign else q, k, v)

    assert route(128, 128, torch.bfloat16) and route(128, 64, torch.bfloat16)
    assert route(100, 100, torch.float32)
    assert not route(100, 100, torch.bfloat16)
    assert not route(128, 60, torch.bfloat16)
    assert not route(128, 128, torch.bfloat16, misalign=True)
    assert [partition_pages(p) * p for p in (1, 8, 16, 3, 256)] == [
        128, 128, 128, 126, 256]


# --------------------------------------------------- dispatch without a card

def test_kernel_impl_on_cpu_tensors_raises():
    """``impl='kernel'`` never runs a CPU stand-in, and neither does a
    kernel wrapper given CPU tensors."""
    x = torch.zeros(2, 8)
    s = torch.ones(8)
    q = torch.zeros(1, 2, 4, 8)
    pool = torch.zeros(3, 4, 2, 8)
    table = torch.zeros(1, 1, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        ops.rmsnorm(x, s, impl="kernel")
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, impl="kernel")
    with pytest.raises(ValueError):
        ops.paged_attention(q[:, :, :1], pool, pool, table, lens,
                            impl="kernel")
    with pytest.raises(ValueError):
        rmsnorm_cuda(x, s)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        paged_attention_cuda(q[:, :, 0], pool, pool, table, lens)
    with pytest.raises(ValueError):
        rmsnorm_bwd_cuda(x, s, x)
    o, lse = flash_attention_torch(q, q, q, with_lse=True)
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, q, q, o, lse, o)
    m = torch.zeros(2, 8)
    sc = torch.zeros(4)
    with pytest.raises(ValueError):
        ops.fused_adamw(x, x, m, m, lr=1.0, scale=1.0, bc1=1.0, bc2=1.0,
                        b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                        impl="kernel")
    with pytest.raises(ValueError):
        fused_adamw_cuda(x, x, m, m, sc, b1=0.9, b2=0.95, eps=1e-8,
                         weight_decay=0.1, apply_wd=True)
    with pytest.raises(ValueError):
        ops.rmsnorm(x, s, impl="pallas")
    # auto on the CPU is the plain version
    np.testing.assert_array_equal(ops.rmsnorm(x + 1, s).numpy(),
                                  rmsnorm_torch(x + 1, s).numpy())


# ---------------------------------------------------------------- ssd scan
#
# Against the sequential oracle the JAX tests' own tolerance (atol 5e-4,
# rtol 5e-3: the chunked form sums in another order and takes exp(a_t -
# a_j) as a difference of cumulative sums); against the chunked jnp path,
# the same algorithm, fp32's.

SSD_CASES = [
    # (Bt, S, H, P, N, chunk)
    (1, 16, 2, 8, 4, 8),        # S a multiple of the chunk
    (2, 40, 3, 8, 4, 16),       # ragged S: the last chunk ends in dt = 0
    (1, 33, 1, 16, 8, 8),       # ragged, one head
    (2, 10, 2, 16, 16, 16),     # S < chunk: Q = S, one short chunk
]
SSD_TOL = dict(atol=5e-4, rtol=5e-3)


def ssd_inputs(Bt, S, H, P, N, *, seed=0, h0=False):
    """x, dt (softplus'd), A < 0, B, C, D and optionally h0, as numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = (rng.standard_normal((Bt, S, H, P)) * 0.5).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)))).astype(f32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(f32)
    B = (rng.standard_normal((Bt, S, N)) * 0.5).astype(f32)
    C = (rng.standard_normal((Bt, S, N)) * 0.5).astype(f32)
    D = rng.standard_normal(H).astype(f32)
    h = (rng.standard_normal((Bt, H, P, N)) * 0.5).astype(f32) if h0 else None
    return x, dt, A, B, C, D, h


def ssd_both(inputs, dtype="float32"):
    """The inputs as (jax, torch) pairs: x, B, C in ``dtype``, the rest
    fp32; h0 None stays None."""
    x, dt, A, B, C, D, h = inputs
    out = []
    for i, a in enumerate((x, dt, A, B, C, D, h)):
        if a is None:
            out.append((None, None))
        else:
            out.append(both(a, dtype if i in (0, 3, 4) else "float32"))
    return [j for j, _ in out], [t for _, t in out]


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_torch_vs_sequential_oracle(case, dtype, h0):
    Bt, S, H, P, N, chunk = case
    (jx, jdt, jA, jB, jC, jD, jh), (x, dt, A, B, C, D, h) = ssd_both(
        ssd_inputs(Bt, S, H, P, N, seed=1, h0=h0), dtype)
    yw, hw = jref.ssd_scan(jx, jdt, jA, jB, jC, jD, h0=jh)
    y, hf = ssd_scan_torch(x, dt, A, B, C, D, chunk=chunk, h0=h)
    assert y.dtype == x.dtype and hf.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(y.numpy(), np.asarray(yw), **SSD_TOL)
    else:
        close(y, yw, dtype)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hw), **SSD_TOL)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_torch_vs_jnp_chunked(case, h0):
    """The plain version is ``ops._ssd_jnp_body``'s arithmetic: y and the
    final state within fp32 rounding, from zeros and from a nonzero h0."""
    Bt, S, H, P, N, chunk = case
    (jx, jdt, jA, jB, jC, jD, jh), (x, dt, A, B, C, D, h) = ssd_both(
        ssd_inputs(Bt, S, H, P, N, seed=2, h0=h0))
    yw, hw = jops._ssd_jnp(jx, jdt, jA, jB, jC, jD, chunk=chunk, h0=jh)
    y, hf = ssd_scan_torch(x, dt, A, B, C, D, chunk=chunk, h0=h)
    close(y, yw, "float32")
    close(hf, hw, "float32")
    # the dispatcher takes the plain version for CPU tensors
    y2, h2 = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk, h0=h)
    assert torch.equal(y2, y) and torch.equal(h2, hf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_torch_vs_pallas_interpret(case, dtype):
    """The Pallas kernel in interpret mode (it takes no h0)."""
    Bt, S, H, P, N, chunk = case
    (jx, jdt, jA, jB, jC, jD, _), (x, dt, A, B, C, D, _) = ssd_both(
        ssd_inputs(Bt, S, H, P, N, seed=3), dtype)
    yw, hw = ssd_scan_pallas(jx, jdt, jA, jB, jC, jD, chunk=chunk,
                             interpret=True)
    y, hf = ssd_scan_torch(x, dt, A, B, C, D, chunk=chunk)
    close(y, yw, dtype)
    np.testing.assert_allclose(hf.numpy(), np.asarray(hw), **F32_TOL)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_passes_torch_vs_plain_jnp_and_pallas(case, dtype, h0):
    """The chunked route's passes (its sequential cumulative sums, one
    C.B^T per (batch, chunk), chunk states, state passing, outputs; fp32
    operands as bf16 parts) against the plain version, the JAX chunked
    path and, from zeros, the Pallas kernel in interpret mode: fp32 at
    fp32's tolerance (two bf16 parts are v to ~2^-17 relative, three to
    ~2^-26), bf16 y at bf16's."""
    Bt, S, H, P, N, chunk = case
    (jx, jdt, jA, jB, jC, jD, jh), (x, dt, A, B, C, D, h) = ssd_both(
        ssd_inputs(Bt, S, H, P, N, seed=8, h0=h0), dtype)
    y, hf = ssd_scan_passes_torch(x, dt, A, B, C, D, chunk=chunk, h0=h)
    assert y.dtype == x.dtype and hf.dtype == torch.float32
    yp, hp = ssd_scan_torch(x, dt, A, B, C, D, chunk=chunk, h0=h)
    close(y, yp.float().numpy(), dtype)
    close(hf, hp.numpy(), "float32")
    yw, hw = jops._ssd_jnp(jx, jdt, jA, jB, jC, jD, chunk=chunk, h0=jh)
    close(y, yw, dtype)
    close(hf, hw, "float32")
    if not h0:
        yw, hw = ssd_scan_pallas(jx, jdt, jA, jB, jC, jD, chunk=chunk,
                                 interpret=True)
        close(y, yw, dtype)
        close(hf, hw, "float32")


def test_one_bf16_operand_fails_the_state_tolerance_and_a_hi_lo_split_holds_it():
    """Why the chunked route gives its three fp32 operands (w_j x_j, the
    entering state, the decay weights) to the tensor cores as bf16 parts:
    at the prefill's chunk of 256 positions, each rounded once to bf16
    puts the final state far outside chip_smoke.py's 1e-4 (element by
    element against the plain version), hi + lo holds it, and the
    kernel's three parts for w_j x_j come no farther.  bf16 x, B, C as the
    Mamba2 layer gives them; fp32 plain PyTorch on the CPU."""
    close = _chip_smoke().close
    (x, dt, A, B, C, D, h) = (torch.from_numpy(a) for a in ssd_inputs(
        1, 512, 4, 64, 64, seed=9, h0=True))
    x, B, C = (t.bfloat16() for t in (x, B, C))
    _, want = ssd_scan_torch(x, dt, A, B, C, D, chunk=256, h0=h)
    ratio = {}
    for name, parts in (("bf16", 1), ("hi_lo", 2), ("kernel", None)):
        _, hf = ssd_scan_passes_torch(x, dt, A, B, C, D, chunk=256, h0=h,
                                      parts=parts)
        ratio[name] = close(hf, want, 1e-4)[1]
    assert ratio["bf16"] > 10.0 and ratio["hi_lo"] < 0.5, ratio
    assert ratio["kernel"] <= ratio["hi_lo"], ratio


def test_ssd_scan_route_choice():
    """The chunked route takes bf16 x, B, C with P and N multiples of 16 up
    to 64, chunks of at most 256 and 16-byte aligned bases and strides
    (the Mamba2 conv output's slices, zamba2_2p7b's and the smoke
    config's); the scalar route the rest: f32, P or N of 8, chunks of 512,
    a copy one element off alignment (``chip_smoke.misaligned``)."""
    smoke = _chip_smoke()

    def route(S, H, P, N, chunk=256, dtype=torch.bfloat16, misalign=False):
        conv = torch.zeros(2, S, H * P + 2 * N, dtype=dtype)
        x = conv[..., :H * P].reshape(2, S, H, P)
        if misalign:
            x = smoke.misaligned(x)
        return chunked_route(x, conv[..., H * P:H * P + N],
                             conv[..., H * P + N:], chunk)

    assert route(1000, 80, 64, 64) and route(40, 8, 16, 16, 16)
    assert route(17, 4, 32, 48) and route(200, 4, 64, 64, 512)
    assert not route(1000, 4, 64, 64, 512)
    assert not route(100, 4, 64, 64, dtype=torch.float32)
    assert not route(100, 4, 8, 64) and not route(100, 4, 64, 8)
    assert not route(100, 4, 80, 64)
    assert not route(100, 4, 64, 64, misalign=True)


def test_ssd_scan_large_dt_and_zero_dt():
    """dt up to 20 drives the cumulative log decay to -1000s: the masked
    exponent above the diagonal overflows and must not leak a NaN, and
    exp must underflow to 0; an all-zero dt leaves the state as it was and
    y = C . h0 + D x."""
    Bt, S, H, P, N, chunk = 1, 40, 2, 8, 4, 16
    x, dt, A, B, C, D, h = ssd_inputs(Bt, S, H, P, N, seed=4, h0=True)
    big = dt * 20.0 / dt.max()
    (jx, jdt, jA, jB, jC, jD, jh), (tx, tdt, tA, tB, tC, tD, th) = ssd_both(
        (x, big, A, B, C, D, h))
    yw, hw = jops._ssd_jnp(jx, jdt, jA, jB, jC, jD, chunk=chunk, h0=jh)
    y, hf = ssd_scan_torch(tx, tdt, tA, tB, tC, tD, chunk=chunk, h0=th)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    close(y, yw, "float32")
    close(hf, hw, "float32")
    zero = torch.zeros_like(tdt)
    y, hf = ssd_scan_torch(tx, zero, tA, tB, tC, tD, chunk=chunk, h0=th)
    assert torch.equal(hf, th)
    want = (torch.einsum("bsn,bhpn->bshp", tC, th)
            + tx * tD[None, None, :, None])
    np.testing.assert_allclose(y.numpy(), want.numpy(), **F32_TOL)


def test_ssd_ref_oracle_vs_jax():
    """The port's sequential oracle is the reference's."""
    (jx, jdt, jA, jB, jC, jD, jh), (x, dt, A, B, C, D, h) = ssd_both(
        ssd_inputs(2, 9, 3, 8, 4, seed=5, h0=True))
    yw, hw = jref.ssd_scan(jx, jdt, jA, jB, jC, jD, h0=jh)
    y, hf = ref.ssd_scan(x, dt, A, B, C, D, h0=h)
    close(y, yw, "float32")
    close(hf, hw, "float32")


def test_ssd_decode_step_vs_jax():
    Bt, H, P, N = 2, 3, 8, 4
    x, dt, A, B, C, D, h = ssd_inputs(Bt, 1, H, P, N, seed=6, h0=True)
    (jx, jdt, jA, jB, jC, jD, jh), (tx, tdt, tA, tB, tC, tD, th) = ssd_both(
        (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0], D, h))
    yw, hw = jops.ssd_decode_step(jx, jdt, jA, jB, jC, jD, jh)
    y, hf = ops.ssd_decode_step(tx, tdt, tA, tB, tC, tD, th)
    close(y, yw, "float32")
    close(hf, hw, "float32")


def test_ssd_scan_kernel_impl_on_cpu_raises():
    """``impl='kernel'`` and the kernel wrappers, forward and backward,
    refuse CPU tensors."""
    x, dt, A, B, C, D, _ = (None if a is None else torch.from_numpy(a)
                            for a in ssd_inputs(1, 8, 2, 8, 4))
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, A, B, C, D, chunk=4, impl="kernel")
    with pytest.raises(ValueError):
        ssd_scan_cuda(x, dt, A, B, C, D, chunk=4)
    with pytest.raises(ValueError):
        ssd_scan_bwd_cuda(x, dt, A, B, C, D, torch.zeros_like(x), chunk=4)


# ------------------------------------------------------- ssd scan backward
#
# The plain backward against JAX's autodiff of the chunked jnp path (the
# reference's differentiable scan) and against torch.autograd of the plain
# forward: the same algorithm, so fp32 within 1e-4 and bf16 (x, B, C and dy
# in bf16, every cotangent) within 2e-2, element by element in the form
# |got - want| <= rtol * (|want| + rms(want)) that chip_smoke.py holds the
# kernel to.

SSD_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def rms_close(got, want, rtol, what=""):
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.isfinite(g).all(), what
    tol = rtol * (np.abs(w) + np.sqrt((w ** 2).mean()))
    worst = float((np.abs(g - w) / np.maximum(tol, 1e-30)).max())
    assert worst <= 1.0, f"{what}: {worst} x tol (rtol {rtol})"


SSD_BWD_CASES = [
    # (name, (Bt, S, H, P, N, chunk), h0, dt scale, dtype)
    ("multiple_of_chunk", (1, 16, 2, 8, 4, 8), False, None, "float32"),
    ("ragged", (2, 40, 3, 8, 4, 16), True, None, "float32"),
    ("chunk_gt_S", (2, 10, 2, 16, 16, 16), True, None, "float32"),
    ("h0_none_ragged", (1, 33, 1, 16, 8, 8), False, None, "float32"),
    ("zero_dt", (1, 24, 2, 8, 4, 8), True, 0.0, "float32"),
    # decays down to exp(-70) within a chunk, yet no exponent of the
    # reference's own mask (exp(a_t - a_j) above the diagonal) overflows:
    # jax.grad of it would give NaN there
    ("large_dt", (1, 24, 2, 8, 4, 8), True, 5.0, "float32"),
    ("ragged_bf16", (2, 40, 3, 8, 4, 16), True, None, "bfloat16"),
    ("chunk_gt_S_bf16", (2, 10, 2, 16, 16, 16), False, None, "bfloat16"),
]


def ssd_bwd_inputs(case, seed=11):
    """The case's inputs and random cotangents dy (x's dtype) and dh_final
    (fp32), as (jax, torch) lists: x, dt, A, B, C, D, h0, dy, dh_final."""
    _, (Bt, S, H, P, N, _), h0, dt_max, dtype = case
    x, dt, A, B, C, D, h = ssd_inputs(Bt, S, H, P, N, seed=seed, h0=h0)
    if dt_max is not None:
        dt = (dt * (dt_max / dt.max())).astype(np.float32)
    rng = np.random.default_rng(seed + 1)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dh = rng.standard_normal((Bt, H, P, N)).astype(np.float32)
    j, t = ssd_both((x, dt, A, B, C, D, h), dtype)
    jdy, tdy = both(dy, dtype)
    jdh, tdh = both(dh, "float32")
    return j + [jdy, jdh], t + [tdy, tdh]


@pytest.mark.parametrize("case", SSD_BWD_CASES, ids=[c[0] for c in
                                                      SSD_BWD_CASES])
def test_ssd_scan_bwd_torch_vs_jax_vjp_and_autograd(case):
    chunk = case[1][-1]
    rtol = 2e-2 if case[-1] == "bfloat16" else 1e-4
    (jx, jdt, jA, jB, jC, jD, jh, jdy, jdh), \
        (x, dt, A, B, C, D, h, dy, dh) = ssd_bwd_inputs(case)
    got = ssd_scan_bwd_torch(x, dt, A, B, C, D, dy, dh, chunk=chunk, h0=h)
    assert [g.dtype for g in got] == [x.dtype, torch.float32, torch.float32,
                                      B.dtype, C.dtype, torch.float32,
                                      torch.float32]
    # jax.vjp of the reference's chunked scan; with no h0 it differentiates
    # a zero state, the plain version's dh0
    jh = jnp.zeros(dh.shape, jnp.float32) if jh is None else jh

    def scan(x, dt, A, B, C, D, h0):
        return jops._ssd_jnp(x, dt, A, B, C, D, chunk=chunk, h0=h0)

    _, vjp = jax.vjp(scan, jx, jdt, jA, jB, jC, jD, jh)
    want = vjp((jdy, jdh))
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        rms_close(g.float().numpy(), np.asarray(w, np.float32), rtol,
                  f"{case[0]} {name} vs jax.vjp")
    # torch.autograd of the plain forward
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, dt, A, B, C, D)]
    h0 = (torch.zeros(dh.shape) if h is None else h).requires_grad_(True)
    y, hf = ssd_scan_torch(*leaves, chunk=chunk, h0=h0)
    want = torch.autograd.grad((y, hf), leaves + [h0], (dy, dh))
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        rms_close(g.float().numpy(), w.float().numpy(), rtol,
                  f"{case[0]} {name} vs autograd")


@pytest.mark.parametrize("case", SSD_BWD_CASES, ids=[c[0] for c in
                                                      SSD_BWD_CASES])
def test_ssd_scan_bwd_passes_torch_vs_jax_vjp_and_plain(case):
    """The tensor-core route's passes in plain PyTorch (sequential
    cumulative sums, the chunk states, the state passing, C.B^T and dW,
    dx, dB and dC, da; fp32 operands of the products as bf16 parts,
    ``BWD_KERNEL_PARTS``) against ``jax.vjp`` of the reference's chunked
    scan and against the plain backward: fp32 within 1e-4 (two bf16 parts
    are v to ~2^-17 relative), bf16 within 2e-2."""
    chunk = case[1][-1]
    rtol = 2e-2 if case[-1] == "bfloat16" else 1e-4
    (jx, jdt, jA, jB, jC, jD, jh, jdy, jdh), \
        (x, dt, A, B, C, D, h, dy, dh) = ssd_bwd_inputs(case)
    got = tssd.ssd_scan_bwd_passes_torch(x, dt, A, B, C, D, dy, dh,
                                         chunk=chunk, h0=h)
    assert [g.dtype for g in got] == [x.dtype, torch.float32, torch.float32,
                                      B.dtype, C.dtype, torch.float32,
                                      torch.float32]
    jh = jnp.zeros(dh.shape, jnp.float32) if jh is None else jh
    _, vjp = jax.vjp(lambda *a: jops._ssd_jnp(*a[:6], chunk=chunk, h0=a[6]),
                     jx, jdt, jA, jB, jC, jD, jh)
    want = vjp((jdy, jdh))
    plain = ssd_scan_bwd_torch(x, dt, A, B, C, D, dy, dh, chunk=chunk, h0=h)
    for name, g, w, p in zip(SSD_BWD_NAMES, got, want, plain):
        rms_close(g.float().numpy(), np.asarray(w, np.float32), rtol,
                  f"{case[0]} {name} vs jax.vjp")
        rms_close(g.float().numpy(), p.float().numpy(), rtol,
                  f"{case[0]} {name} vs the plain backward")


def test_one_bf16_operand_fails_the_bwd_tolerance_and_two_parts_hold_it():
    """Why the backward's tensor-core route gives its fp32 operands to the
    tensor cores as bf16 parts: at a 512-long sequence in chunks of 256,
    with x, B, C and dy in bf16 as the Mamba2 layer gives them, one bf16
    value each puts dh0 (through the chunk states' cotangent sums) far
    outside chip_smoke.py's 1e-3, element by element against the plain
    backward; hi + lo holds ddt, dA and dh0, and the kernel's counts
    (``BWD_KERNEL_PARTS``) hold every cotangent's tolerance.  fp32 plain
    PyTorch on the CPU."""
    smoke = _chip_smoke()
    case = ("s512", (1, 512, 4, 64, 64, 256), True, None, "bfloat16")
    _, (x, dt, A, B, C, D, h, dy, dh) = ssd_bwd_inputs(case, seed=9)
    want = ssd_scan_bwd_torch(x, dt, A, B, C, D, dy, dh, chunk=256, h0=h)
    ratio = {}
    for label, parts in (("bf16", 1), ("hi_lo", 2), ("kernel", None)):
        got = tssd.ssd_scan_bwd_passes_torch(x, dt, A, B, C, D, dy, dh,
                                             chunk=256, h0=h, parts=parts)
        ratio[label] = {
            name: smoke.close(g, w, smoke.ssd_bwd_rtol(name, g.dtype))[1]
            for name, g, w in zip(SSD_BWD_NAMES, got, want)}
    assert ratio["bf16"]["dh0"] > 1.0, ratio
    assert all(ratio["hi_lo"][n] < 0.1 for n in ("ddt", "dA", "dh0")), ratio
    assert all(r <= 1.0 for r in ratio["kernel"].values()), ratio


def test_ssd_scan_bwd_route_choice():
    """The backward takes its tensor-core route where the forward takes
    its chunked route (bf16 x, B, C; P and N multiples of 16 up to 64;
    chunks of at most 256; 16-byte aligned bases and strides) and dy is
    16-byte aligned too: the Mamba2 conv output's slices, zamba2_2p7b's
    and the smoke config's.  The scalar route takes the rest: f32, P of
    8, chunks of 512, a copy one element off alignment
    (``chip_smoke.misaligned``) of x or of dy."""
    smoke = _chip_smoke()

    def route(S, H, P, N, chunk=256, dtype=torch.bfloat16, misalign=None):
        conv = torch.zeros(2, S, H * P + 2 * N, dtype=dtype)
        x = conv[..., :H * P].reshape(2, S, H, P)
        dy = torch.zeros(2, S, H, P, dtype=dtype)
        if misalign == "x":
            x = smoke.misaligned(x)
        if misalign == "dy":
            dy = smoke.misaligned(dy)
        return tssd.bwd_chunked_route(x, conv[..., H * P:H * P + N],
                                      conv[..., H * P + N:], dy, chunk)

    assert route(2048, 80, 64, 64) and route(40, 8, 16, 16, 16)
    assert route(17, 4, 32, 48) and route(200, 4, 64, 64, 512)
    assert not route(1000, 4, 64, 64, 512)
    assert not route(100, 4, 64, 64, dtype=torch.float32)
    assert not route(100, 4, 8, 64) and not route(100, 4, 64, 8)
    assert not route(100, 4, 64, 64, misalign="x")
    assert not route(100, 4, 64, 64, misalign="dy")


def test_ssd_scan_bwd_torch_very_large_dt_vs_sequential_oracle():
    """dt up to 20 drives a within a chunk to -1000s: the chunked jnp
    path's own gradient is NaN there (its mask multiplies an overflowed
    exponent by 0), the plain backward takes exponents only where t >= j
    and stays finite.  Held against autograd of the sequential oracle
    ``ref.ssd_scan`` (another algorithm: the JAX tests' rtol 5e-3)."""
    case = ("dt20", (1, 40, 2, 8, 4, 16), True, 20.0, "float32")
    _, (x, dt, A, B, C, D, h, dy, dh) = ssd_bwd_inputs(case, seed=4)
    got = ssd_scan_bwd_torch(x, dt, A, B, C, D, dy, dh, chunk=16, h0=h)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, dt, A, B, C, D, h)]
    y, hf = ref.ssd_scan(*leaves[:6], h0=leaves[6])
    want = torch.autograd.grad((y, hf), leaves, (dy, dh))
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        rms_close(g.numpy(), w.numpy(), 5e-3, f"dt20 {name}")


def test_ssd_scan_torch_gradient_is_finite_at_large_dt():
    """Autograd of the plain forward at dt up to 20: its intra-chunk mask
    goes on the exponent, so no overflowed exp(a_t - a_j) above the
    diagonal meets a zero of the mask in the backward (inf * 0 = NaN, as
    in the reference's ``_ssd_jnp``, whose gradient is NaN there).  At
    zamba2_2p7b's full width with random weights the chunks' decays reach
    that range, and the plain train step's gradients were NaN.  The
    gradients equal the plain backward's."""
    case = ("dt20", (1, 40, 2, 8, 4, 16), True, 20.0, "float32")
    _, (x, dt, A, B, C, D, h, dy, dh) = ssd_bwd_inputs(case, seed=4)
    leaves = [t.detach().clone().requires_grad_(True)
              for t in (x, dt, A, B, C, D, h)]
    y, hf = ssd_scan_torch(*leaves[:6], chunk=16, h0=leaves[6])
    got = torch.autograd.grad((y, hf), leaves, (dy, dh))
    want = ssd_scan_bwd_torch(x, dt, A, B, C, D, dy, dh, chunk=16, h0=h)
    for name, g, w in zip(SSD_BWD_NAMES, got, want):
        rms_close(g.numpy(), w.numpy(), 1e-4, f"dt20 autograd {name}")


class _Ctx:
    """Stands in for autograd's context in a direct call of
    ``_SSDScan.backward``."""

    def __init__(self, saved, chunk, needs):
        self.saved_tensors, self.chunk = saved, chunk
        self.needs_input_grad = needs


def test_ssd_scan_autograd_function_wiring_on_cpu(monkeypatch):
    """``ops.ssd_scan`` on a tensor that selects the kernel and needs a
    gradient goes through ``_SSDScan``: its forward is the forward kernel
    and its backward the backward kernel (both stood in for on the CPU by
    their plain versions), with x, B and C strided views of a conv output
    and the final state unused (its cotangent None); every gradient equals
    autograd of the plain forward.  Inputs that need no gradient get
    None."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(x, dt, A, B, C, D, *, chunk, h0=None):
        calls["fwd"] += 1
        return ssd_scan_torch(x, dt, A, B, C, D, chunk=chunk, h0=h0)

    def bwd(*args, chunk, h0=None):
        calls["bwd"] += 1
        assert args[-1] is None                  # dh_final: unused state
        return ssd_scan_bwd_torch(*args, chunk=chunk, h0=h0)

    monkeypatch.setattr(tssd, "ssd_scan_cuda", fwd)
    monkeypatch.setattr(tssd, "ssd_scan_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "_use_kernel", lambda impl, t: impl != "torch")
    Bt, S, H, P, N, chunk = 2, 40, 3, 8, 4, 16
    rng = np.random.default_rng(12)
    conv0 = torch.from_numpy(rng.standard_normal(
        (Bt, S, H * P + 2 * N)).astype(np.float32) * 0.5)
    dt0 = torch.from_numpy(np.log1p(np.exp(rng.standard_normal(
        (Bt, S, H)))).astype(np.float32))
    A0 = torch.from_numpy(-np.exp(rng.standard_normal(H) * 0.3)
                          .astype(np.float32))
    D0 = torch.from_numpy(rng.standard_normal(H).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((Bt, S, H, P))
                          .astype(np.float32))
    grads = {}
    for impl in ("auto", "torch"):
        leaves = [t.clone().requires_grad_(True)
                  for t in (conv0, dt0, A0, D0)]
        conv, dt, A, D = leaves
        x = conv[..., :H * P].reshape(Bt, S, H, P)
        B, C = conv[..., H * P:H * P + N], conv[..., H * P + N:]
        assert x.stride(1) == H * P + 2 * N and B.stride(1) == x.stride(1)
        y, _ = ops.ssd_scan(x, dt, A, B, C, D, chunk=chunk, impl=impl)
        grads[impl] = torch.autograd.grad(y, leaves, dy)
    assert calls == {"fwd": 1, "bwd": 1}
    for g, w in zip(grads["auto"], grads["torch"]):
        rms_close(g.numpy(), w.numpy(), 1e-5)
    # only the inputs that need a gradient get one
    saved = (x.detach(), dt0, A0, B.detach(), C.detach(), D0, None)
    needs = (True, False, True, False, True, False, False, False)
    out = ops._SSDScan.backward(_Ctx(saved, chunk, needs), dy, None)
    assert len(out) == 8
    assert [g is not None for g in out] == list(needs)
    assert calls["bwd"] == 2
