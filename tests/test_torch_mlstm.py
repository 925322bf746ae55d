"""The mLSTM chunked scan as one op (``kernels.ops.mlstm_scan``) and the
plain versions beside its kernels (``kernels/mlstm.py``), against the JAX
package's chunked scan (``repro.kernels.ops.mlstm_scan``, a ``lax.scan``
of ``chunk_step``) and its block (``repro.models.ssm.mlstm_fwd``), and
against autograd of the port's loop, on the CPU.

Held:
  - ``mlstm_scan_bwd_torch``'s cotangents of q, k, v, both gates and the
    given carry against autograd of ``mlstm_scan_torch`` within 1e-5 and
    against ``jax.vjp`` of the reference's chunked scan within 1e-4: fp32
    and bf16 inputs, from zeros and from a carry, S = 37 at chunks 8 and
    64 (64 runs one chunk), with and without the final carry's
    cotangents (all three or one), and inputs built to tie in m_t's
    maximum (m0 + G_L against the row maximum, and every j of the row
    maximum among themselves, in every chunk);
  - ``mlstm_saved_torch``'s layout: the carries entering each chunk, the
    last of them leading to the final carry;
  - the block's cotangents (x, every param and the carry) with
    ``mlstm_scan_bwd_torch`` as the op's backward against autograd of
    the plain loop within 1e-5 and against ``jax.vjp`` of the
    reference's ``mlstm_fwd`` within 1e-4, from zeros and from a carry;
  - ``_MLSTMScan``'s wiring (the kernels stood in for by their plain
    versions): a training call (the final carry's cotangents None) and
    one with them give autograd's gradients of the plain loop;
  - ``impl="kernel"`` on a CPU tensor raises, and the kernels' wrappers
    refuse a shape or dtype they have no instance for.

Each distance is |got - want| <= rtol * (|want| + rms(want)), element by
element, as ``chip_smoke.close`` measures the kernels on the card.  bf16
inputs are held through their fp32 values: autograd's cotangents of a
bf16 input are its fp32 ones rounded, and two fp32 values a last bit
apart can round a whole bf16 step apart; the bf16 call's cotangents are
held to be its fp32 values rounded, bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import mlstm as ml  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

ARCH = "xlstm_350m"
D_MODEL = 32
NAMES = ("q", "k", "v", "i_gate", "f_gate", "dC0", "dn0", "dm0")


def held(got, want, rtol, what=""):
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float64)
    w = np.asarray(want.detach().float() if isinstance(want, torch.Tensor)
                   else np.asarray(want, np.float32), np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.isfinite(g).all(), what
    tol = rtol * (np.abs(w) + np.sqrt((w ** 2).mean()))
    worst = float((np.abs(g - w) / np.maximum(tol, 1e-30)).max())
    assert worst <= 1.0, f"{what}: {worst} x the tolerance"


# ========================================== the plain backward, the op

CASES = {
    # name: (chunk, carry, final cotangents given, dtype, ties)
    "f32_zeros": (8, False, "", "float32", False),
    "f32_zeros_final": (8, False, "Cnm", "float32", False),
    "f32_one_chunk": (64, True, "Cnm", "float32", False),
    "f32_carry": (8, True, "", "float32", False),
    "f32_carry_dC_only": (8, True, "C", "float32", False),
    "bf16_carry_final": (8, True, "Cnm", "bfloat16", False),
    "ties": (8, True, "Cnm", "float32", True),
}


def bf16_values(a):
    return np.asarray(torch.from_numpy(a).bfloat16().float())


def scan_inputs(case):
    """(q, k, v, i, f) as numpy fp32 (bf16 values in the bf16 case), a
    carry or None, dh and the final carry's three cotangents (each None
    unless named), at B 2, H 2, S 37, Dk 16, Dv 8."""
    chunk, carry, final, dtype, ties = CASES[case]
    B, H, S, Dk, Dv = 2, 2, 37, 16, 8
    rng = np.random.default_rng(len(case) * 13 + chunk)
    xs = [rng.standard_normal((B, H, S, Dk), dtype=np.float32),
          rng.standard_normal((B, H, S, Dk), dtype=np.float32),
          rng.standard_normal((B, H, S, Dv), dtype=np.float32),
          rng.standard_normal((B, H, S), dtype=np.float32),
          rng.standard_normal((B, H, S), dtype=np.float32) + 2.0]
    c0 = None
    if carry:
        c0 = [rng.standard_normal((B, H, Dk, Dv), dtype=np.float32),
              rng.standard_normal((B, H, Dk), dtype=np.float32),
              rng.standard_normal((B, H), dtype=np.float32)]
    if ties:
        # f = 80: G ~ -1e-35 t, so every d[L, j] = G_L - G_j + 0.5 rounds
        # to 0.5 = m0 + G_L: each chunk's m_L ties between its two
        # branches, and its row maximum among all j
        xs[3][:] = 0.5
        xs[4][:] = 80.0
        c0[2][:] = 0.5
    dh = rng.standard_normal((B, H, S, Dv), dtype=np.float32)
    if dtype == "bfloat16":
        xs, dh = [bf16_values(a) for a in xs], bf16_values(dh)
    fin = [rng.standard_normal((B, H, Dk, Dv), dtype=np.float32),
           rng.standard_normal((B, H, Dk), dtype=np.float32),
           rng.standard_normal((B, H), dtype=np.float32)]
    fin = [a if n in final else None for a, n in zip(fin, "Cnm")]
    return chunk, xs, c0, dh, fin, dtype


def t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def autograd_grads(xs, c0, dh, fin, chunk):
    leaves = [t(a).requires_grad_() for a in xs]
    cl = None if c0 is None else [t(a).requires_grad_() for a in c0]
    h, carry = ml.mlstm_scan_torch(*leaves, chunk=chunk, carry=cl)
    outs = [h] + [o for o, d in zip(carry, fin) if d is not None]
    cots = [t(dh)] + [t(d) for d in fin if d is not None]
    return torch.autograd.grad(outs, leaves + (cl or []), cots)


def vjp_grads(xs, c0, dh, fin, chunk):
    B, H, _, Dk = xs[0].shape
    Dv = xs[2].shape[-1]
    zeros = [np.zeros((B, H, Dk, Dv), np.float32),
             np.zeros((B, H, Dk), np.float32), np.zeros((B, H), np.float32)]
    cots = (jnp.asarray(dh), tuple(jnp.asarray(z if d is None else d)
                                   for d, z in zip(fin, zeros)))
    if c0 is None:
        def fn(*a):
            return jops.mlstm_scan(*a, chunk=chunk)
        args = xs
    else:
        def fn(*a):
            return jops.mlstm_scan(*a[:5], chunk=chunk, carry=tuple(a[5:]))
        args = xs + c0
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    return vjp(cots)


@pytest.mark.parametrize("case", list(CASES))
def test_mlstm_scan_bwd_torch_vs_autograd_and_jax_vjp(case):
    """The hand-derived reverse-chunk loop gives autograd's cotangents of
    the plain loop (q, k, v, both gates and the carry given) within 1e-5
    and the reference's ``jax.vjp`` within 1e-4; in bf16 the call's
    cotangents are its fp32 ones rounded, in the inputs' dtype."""
    chunk, xs, c0, dh, fin, dtype = scan_inputs(case)
    got, d0 = ml.mlstm_scan_bwd_torch(
        *(t(a) for a in xs), t(dh), tuple(t(d) for d in fin), chunk=chunk,
        carry=None if c0 is None else tuple(t(a) for a in c0))
    got = list(got) + list(d0 or ())
    want = autograd_grads(xs, c0, dh, fin, chunk)
    jwant = vjp_grads(xs, c0, dh, fin, chunk)
    assert len(got) == len(want) == len(jwant) == (5 if c0 is None else 8)
    for name, g, a, j in zip(NAMES, got, want, jwant):
        assert g.dtype == torch.float32
        held(g, a, 1e-5, f"{name} against autograd")
        held(g, np.asarray(j), 1e-4, f"{name} against jax.vjp")
    if dtype == "bfloat16":
        bf = [t(a).bfloat16() for a in xs]
        gb, db = ml.mlstm_scan_bwd_torch(
            *bf, t(dh).bfloat16(), tuple(t(d) for d in fin), chunk=chunk,
            carry=tuple(t(a) for a in c0))
        for name, g, w in zip(NAMES, list(gb) + list(db), got):
            want_dtype = torch.bfloat16 if name[0] != "d" else torch.float32
            assert g.dtype == want_dtype, name
            assert torch.equal(g, w.to(want_dtype)), name


def test_mlstm_saved_torch_layout_and_ties():
    """The saved carries are the ones entering each chunk (the first the
    carry given, the loop's final one after the last chunk), the row
    maxima and fp32 h are the loop's; the tie case does tie in every
    chunk (m0 + G_L == mloc_L, every j of the last row at the maximum)."""
    chunk, xs, c0, _, _, _ = scan_inputs("ties")
    x, c = [t(a) for a in xs], tuple(t(a) for a in c0)
    saved, fin = ml.mlstm_saved_torch(*x, chunk=chunk, carry=c)
    Cin, nin, minc, G, mloc, Dp, h32, Cf, nf = saved
    B, H, S, Dk = x[0].shape
    nc = -(-S // chunk)
    assert Cin.shape == (B, H, nc, Dk, x[2].shape[-1])
    assert G.shape == mloc.shape == Dp.shape == (B, H, nc * chunk)
    assert h32.shape == (B, H, nc * chunk, x[2].shape[-1])
    for got, want in zip((Cin[:, :, 0], nin[:, :, 0], minc[:, :, 0]), c):
        assert torch.equal(got, want)
    assert torch.equal(Cf, fin[0]) and torch.equal(nf, fin[1])
    h, _ = ml.mlstm_scan_torch(*x, chunk=chunk, carry=c)
    assert torch.equal(h32[:, :, :S], h)
    last = torch.arange(chunk - 1, nc * chunk, chunk)
    assert torch.equal(minc + G[..., last], mloc[..., last])
    assert torch.equal(mloc[..., last], torch.full_like(minc, 0.5))


# ======================================== the block's cotangents vs JAX

class _PlainBwd(torch.autograd.Function):
    """The plain loop forward, ``mlstm_scan_bwd_torch`` backward."""

    @staticmethod
    def forward(ctx, q, k, v, i_gate, f_gate, C0, n0, m0, chunk):
        carry = None if C0 is None else (C0, n0, m0)
        h, fin = ml.mlstm_scan_torch(q, k, v, i_gate, f_gate, chunk=chunk,
                                     carry=carry)
        ctx.save_for_backward(q, k, v, i_gate, f_gate, C0, n0, m0)
        ctx.chunk = chunk
        return (h, *fin)

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        q, k, v, i_gate, f_gate, *carry = ctx.saved_tensors
        grads, d0 = ml.mlstm_scan_bwd_torch(
            q, k, v, i_gate, f_gate, dh, (dC, dn, dm), chunk=ctx.chunk,
            carry=None if carry[0] is None else tuple(carry))
        return grads + tuple(d0 or (None,) * 3) + (None,)


def block_case(case):
    """Params (JAX's), x, a carry or None and the cotangents."""
    jc, c = jconfigs.get_smoke(ARCH).xlstm, configs.get_smoke(ARCH).xlstm
    inner, Dk, Dv, H = ssm._mlstm_dims(D_MODEL, c)
    jp = jssm.mlstm_init(jax.random.PRNGKey(51), D_MODEL, jc, jnp.float32)
    rng = np.random.default_rng(52 + len(case))
    S = 37
    x = rng.standard_normal((2, S, D_MODEL), dtype=np.float32)
    carry = None
    if case == "carry":
        carry = [rng.standard_normal((2, H, Dk, Dv), dtype=np.float32),
                 rng.standard_normal((2, H, Dk), dtype=np.float32),
                 rng.standard_normal((2, H), dtype=np.float32)]
    dout = rng.standard_normal((2, S, D_MODEL), dtype=np.float32)
    dcar = [rng.standard_normal((2, H, Dk, Dv), dtype=np.float32),
            rng.standard_normal((2, H, Dk), dtype=np.float32),
            rng.standard_normal((2, H), dtype=np.float32)]
    return jc, c, jp, x, carry, dout, dcar


def port_grads(c, jp, x, carry, dout, dcar, plain_bwd):
    """The block's cotangents of x, every param and the carry: the block
    run from no state with the op handed the test's carry, so nothing is
    written in place."""
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    names = sorted(tp)
    for k in names:
        tp[k].requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    cl = (None if carry is None
          else [torch.from_numpy(a.copy()).requires_grad_() for a in carry])
    real = ops.mlstm_scan

    def with_carry(q, k, v, ig, fg, *, chunk, carry, impl):
        assert carry is None and impl == "auto"
        if plain_bwd:
            h, *fin = _PlainBwd.apply(q, k, v, ig, fg,
                                      *(cl or (None,) * 3), chunk)
            return h, tuple(fin)
        return real(q, k, v, ig, fg, chunk=chunk, carry=cl, impl=impl)

    ops.mlstm_scan = with_carry
    try:
        out, new = ssm.mlstm_fwd(tp, tx, c, D_MODEL)
    finally:
        ops.mlstm_scan = real
    ins = [tx] + [tp[k] for k in names] + (cl or [])
    return names, torch.autograd.grad(
        [out, *new["mlstm"]], ins,
        [torch.from_numpy(dout)] + [torch.from_numpy(d) for d in dcar])


@pytest.mark.parametrize("case", ["zeros", "carry"])
def test_mlstm_block_cotangents_vs_jax_vjp(case):
    """With ``mlstm_scan_bwd_torch`` as the op's backward, the block's
    cotangents of x, every param and the carry (and the final carry's
    cotangents given): autograd's of the plain loop within 1e-5, the
    reference's ``jax.vjp`` of its ``mlstm_fwd`` within 1e-4."""
    jc, c, jp, x, carry, dout, dcar = block_case(case)
    names, got = port_grads(c, jp, x, carry, dout, dcar, plain_bwd=True)
    _, auto = port_grads(c, jp, x, carry, dout, dcar, plain_bwd=False)
    inner = ssm._mlstm_dims(D_MODEL, c)[0]
    conv = jnp.zeros((2, 3, inner), jnp.float32)

    def fwd(p, xx, *car):
        state = None if not car else {"conv": conv, "mlstm": tuple(car)}
        out, st = jssm.mlstm_fwd(p, xx, jc, D_MODEL, state=state)
        return out, st["mlstm"]

    args = [jp, jnp.asarray(x)] + [jnp.asarray(a) for a in carry or ()]
    _, vjp = jax.vjp(fwd, *args)
    jg = vjp((jnp.asarray(dout), tuple(jnp.asarray(d) for d in dcar)))
    want = [jg[1]] + [jg[0][k] for k in names] + list(jg[2:])
    labels = ["x"] + names + ["C0", "n0", "m0"][:len(carry or ())]
    assert len(got) == len(auto) == len(want) == len(labels)
    for name, g, a, j in zip(labels, got, auto, want):
        held(g, a, 1e-5, f"{name} against autograd")
        held(g, np.asarray(j), 1e-4, f"{name} against jax.vjp")


# ============================================ the op's autograd wiring

class _Ctx:
    def __init__(self, saved, chunk, needs):
        self.saved_tensors = saved
        self.chunk = chunk
        self.needs_input_grad = needs


def test_mlstm_scan_autograd_function_wiring_on_cpu(monkeypatch):
    """``ops.mlstm_scan`` on a tensor that selects the kernel and needs a
    gradient goes through ``_MLSTMScan``: its forward is the forward
    kernels (saving what the backward reads) and its backward the
    backward kernels, both stood in for on the CPU by their plain
    versions; q, k and v strided views as the block makes them.  A
    training call (the carry unused: its cotangents None) and one with a
    carry and its cotangents give autograd's gradients of the plain
    loop; inputs that need no gradient get None."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(q, k, v, ig, fg, *, chunk, carry=None, save=False):
        calls["fwd"] += 1
        assert save
        saved, fin = ml.mlstm_saved_torch(q, k, v, ig, fg, chunk=chunk,
                                          carry=carry)
        h, _ = ml.mlstm_scan_torch(q, k, v, ig, fg, chunk=chunk,
                                   carry=carry)
        return h, fin, saved

    def bwd(q, k, v, ig, fg, dh, dfinal, *, chunk, saved, carry=None):
        calls["bwd"] += 1
        return ml.mlstm_scan_bwd_torch(q, k, v, ig, fg, dh, dfinal,
                                       chunk=chunk, carry=carry, saved=saved)

    monkeypatch.setattr(ml, "mlstm_scan_cuda", fwd)
    monkeypatch.setattr(ml, "mlstm_scan_bwd_cuda", bwd)
    monkeypatch.setattr(ops, "_use_kernel", lambda impl, x: impl != "torch")
    B, S, H, Dk, Dv, chunk = 2, 29, 2, 8, 16, 8
    rng = np.random.default_rng(61)
    proj0 = torch.from_numpy(rng.standard_normal(
        (B, S, H * (2 * Dk + Dv + 2))).astype(np.float32))
    c0 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((B, H, Dk, Dv), (B, H, Dk), (B, H))]
    dh = torch.from_numpy(rng.standard_normal((B, H, S, Dv))
                          .astype(np.float32))
    dC = torch.from_numpy(rng.standard_normal((B, H, Dk, Dv))
                          .astype(np.float32))
    for with_carry in (False, True):
        grads = {}
        for impl in ("auto", "torch"):
            proj = proj0.clone().requires_grad_()
            cl = [a.clone().requires_grad_() for a in c0] if with_carry \
                else None
            q = proj[..., :H * Dk].reshape(B, S, H, Dk).transpose(1, 2)
            k = proj[..., H * Dk:2 * H * Dk].reshape(B, S, H, Dk) \
                .transpose(1, 2)
            v = proj[..., 2 * H * Dk:H * (2 * Dk + Dv)].reshape(
                B, S, H, Dv).transpose(1, 2)
            gates = proj[..., H * (2 * Dk + Dv):].reshape(B, S, 2, H)
            ig, fg = gates[:, :, 0].transpose(1, 2), \
                gates[:, :, 1].transpose(1, 2)
            h, (C, n, m) = ops.mlstm_scan(q, k, v, ig, fg, chunk=chunk,
                                          carry=cl, impl=impl)
            outs, cots = [h], [dh]
            if with_carry:
                outs, cots = [h, C], [dh, dC]
            grads[impl] = torch.autograd.grad(outs, [proj] + (cl or []),
                                              cots)
        for g, w in zip(grads["auto"], grads["torch"]):
            held(g, w, 1e-5, f"carry={with_carry}")
    assert calls == {"fwd": 2, "bwd": 2}
    # only the inputs that need a gradient get one
    x = [torch.randn(B, H, S, Dk), torch.randn(B, H, S, Dk),
         torch.randn(B, H, S, Dv), torch.randn(B, H, S),
         torch.randn(B, H, S)]
    saved, _ = ml.mlstm_saved_torch(*x, chunk=chunk)
    needs = (True, False, True, False, True, False, False, False, False)
    out = ops._MLSTMScan.backward(_Ctx((*x, None, None, *saved), chunk,
                                       needs), dh, None, None, None)
    assert len(out) == 9
    assert [g is not None for g in out] == list(needs)


# ============================================================== refusals

def test_mlstm_scan_kernel_refuses_cpu_tensors_and_unbuilt_shapes():
    """``impl="kernel"`` on a CPU tensor raises (no fallback to the plain
    loop); the kernels' wrappers refuse head widths, chunks and dtypes
    they have no instance for before anything else, and a CPU tensor;
    an unknown impl raises."""
    def xs(Dk=16, Dv=8, S=12, dtype=torch.float32):
        return [torch.zeros(1, 2, S, Dk, dtype=dtype),
                torch.zeros(1, 2, S, Dk, dtype=dtype),
                torch.zeros(1, 2, S, Dv, dtype=dtype),
                torch.zeros(1, 2, S, dtype=dtype),
                torch.zeros(1, 2, S, dtype=dtype)]

    with pytest.raises(ValueError, match="CUDA"):
        ops.mlstm_scan(*xs(), chunk=8, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.mlstm_scan(*xs(), chunk=8, impl="x")
    with pytest.raises(ValueError, match="head dims"):
        ml.mlstm_scan_cuda(*xs(Dk=300), chunk=8)
    with pytest.raises(ValueError, match="head dims"):
        ml.mlstm_scan_cuda(*xs(Dv=520), chunk=8)
    with pytest.raises(ValueError, match="chunk"):
        ml.mlstm_scan_cuda(*xs(S=400), chunk=300)
    mixed = xs()
    mixed[2] = mixed[2].bfloat16()
    with pytest.raises(ValueError, match="bf16/f32"):
        ml.mlstm_scan_cuda(*mixed, chunk=8)
    with pytest.raises(ValueError, match="bf16/f32"):
        ml.mlstm_scan_cuda(*xs(dtype=torch.float16), chunk=8)
    with pytest.raises(ValueError, match="head dims"):
        ml.mlstm_scan_bwd_cuda(*xs(Dk=300), torch.zeros(1, 2, 12, 8),
                               chunk=8, saved=())
    # a shape they are built for, on the CPU: the device check refuses it
    with pytest.raises(ValueError, match="CUDA"):
        ml.mlstm_scan_cuda(*xs(Dk=256, Dv=512), chunk=256)
    h, (C, n, m) = ops.mlstm_scan(*xs(), chunk=8)
    assert h.shape == (1, 2, 12, 8) and C.shape == (1, 2, 16, 8)
