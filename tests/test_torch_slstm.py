"""The sLSTM recurrence as one op (``kernels.ops.slstm_scan``) and the
plain versions beside its kernels (``kernels/slstm.py``), against the JAX
package's ``slstm_fwd`` (a ``lax.scan``) and against autograd of the
port's loop, on the CPU at ``get_smoke("xlstm_350m")``'s sLSTM (2 heads
of 16 at d_model 32).

Held:
  - ``ssm.slstm_fwd`` through the plain ``ops.slstm_scan`` against the
    reference's ``slstm_fwd``: fp32 and bf16, from the initial state and
    from a given one, at S = 1 (a decode step) and S > 1; the output and
    the four states;
  - ``slstm_scan_bwd_torch``'s cotangents of the gates, of r and of the
    initial state against autograd of ``slstm_scan_torch``, within 1e-5
    (fp32), with and without a state, bf16 gates, S = 1, and inputs built
    to tie at both maxima (m = max(logsigmoid(f) + m_prev, i) and
    max(|n|, 1)) and to give n = 0 (where |n| has slope 0);
  - the block's cotangents (x, ``w_gates``, ``r_gates`` and the four
    states) with ``slstm_scan_bwd_torch`` as the op's backward against
    autograd of the plain loop within 1e-5 and against ``jax.vjp`` of the
    reference's ``slstm_fwd`` within 1e-4, the ties among them;
  - ``impl="kernel"`` on a CPU tensor raises, and the kernels' wrappers
    refuse a head width they have no instance for.

Each distance is |got - want| <= rtol * (|want| + rms(want)), element by
element, as ``chip_smoke.close`` measures the kernels on the card.  The
block-level comparisons take the sLSTM's bf16 stacking of h out of both
packages (``unround``, as ``tests/test_torch_xlstm.py`` does for the
fp32 stack): its rounding turns the two frameworks' last-bit differences
into whole bf16 steps that the output norm carries.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import slstm as sl  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

ARCH = "xlstm_350m"
D_MODEL = 32
F32_TOL = dict(atol=1e-5, rtol=1e-4)    # tests/test_torch_xlstm.py's


def held(got, want, rtol, what=""):
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float64)
    w = np.asarray(want.detach().float() if isinstance(want, torch.Tensor)
                   else np.asarray(want, np.float32), np.float64)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    tol = rtol * (np.abs(w) + np.sqrt((w ** 2).mean()))
    worst = float((np.abs(g - w) / np.maximum(tol, 1e-30)).max())
    assert worst <= 1.0, f"{what}: {worst} x the tolerance"


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               **(tol or F32_TOL))


def block_cfgs():
    return (jconfigs.get_smoke(ARCH).xlstm, configs.get_smoke(ARCH).xlstm)


class _JnpStackingF32:
    """``jax.numpy`` with ``bfloat16`` read as float32 (the reference's
    sLSTM rounds its stacked h with ``h.astype(jnp.bfloat16)``)."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def unround(monkeypatch):
    monkeypatch.setattr(jssm, "jnp", _JnpStackingF32())
    monkeypatch.setattr(ssm, "SLSTM_STACK_DTYPE", torch.float32)


def xla_bf16_silu(t):
    """silu rounded op by op, as XLA:CPU computes it in bf16."""
    return t * torch.reciprocal(1 + torch.exp(-t))


def state_arrays(rng, B, H, Dh):
    s = [rng.standard_normal((B, H, Dh), dtype=np.float32) for _ in range(4)]
    s[2] = np.abs(s[2]) + 1.0
    return s


# ======================================================= forward, the block

@pytest.mark.parametrize("S", [1, 9])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_fwd_through_the_op_vs_reference(dtype, with_state, S):
    """``ssm.slstm_fwd`` runs the recurrence through ``ops.slstm_scan``
    (its plain loop here): the output and (h, c, n, m) against the
    reference's, fp32 at ``tests/test_torch_xlstm.py``'s tolerance, bf16
    within 2e-2 of each one's span."""
    jc, c = block_cfgs()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jp = jssm.slstm_init(jax.random.PRNGKey(21), D_MODEL, jc, jdt)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(22 + S)
    x = rng.standard_normal((2, S, D_MODEL), dtype=np.float32)
    jstate = state = None
    if with_state:
        s = state_arrays(rng, 2, c.n_heads, D_MODEL // c.n_heads)
        jstate = {"slstm": tuple(jnp.asarray(a) for a in s)}
        state = {"slstm": tuple(torch.from_numpy(a.copy()) for a in s)}
    calls = []
    real = ops.slstm_scan

    def counted(*a, **kw):
        calls.append(kw["impl"])
        return real(*a, **kw)

    silu = torch.nn.functional.silu
    ops.slstm_scan = counted
    if dtype == "bfloat16":
        torch.nn.functional.silu = xla_bf16_silu
    try:
        got, gst = ssm.slstm_fwd(tp, torch.from_numpy(x).to(tdt), c,
                                 D_MODEL, state=state)
    finally:
        ops.slstm_scan = real
        torch.nn.functional.silu = silu
    assert calls == ["auto"]
    want, wst = jssm.slstm_fwd(jp, jnp.asarray(x).astype(jdt), jc, D_MODEL,
                               state=jstate)
    if dtype == "float32":
        tol = F32_TOL
    else:
        span = float(np.abs(np.asarray(want, np.float32)).max())
        tol = dict(atol=2e-2 * span, rtol=2e-2)
    assert_close(got, want, **tol)
    for g, w in zip(gst["slstm"], wst["slstm"]):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert_close(g, w, **(F32_TOL if dtype == "float32" else dict(
            atol=2e-2 * float(np.abs(np.asarray(w)).max()), rtol=2e-2)))
    if state is not None:
        assert gst is state


# =========================================== the plain backward, the op

def tie_inputs(B, S, H, Dh, seed):
    """Gates, r and a state whose first step ties at both maxima on half
    the dims and gives n = 0 on the other half: r's i and f columns and
    h_{-1} zero (so g = gx exactly), f = 30 (logsigmoid(f) + m rounds to
    m = 0.5), i = 0.5 (tie; i' = f' = 1, so n = 0 + 1 ties with 1) or
    -200 (i' = 0, so n stays 0)."""
    rng = np.random.default_rng(seed)
    gx = rng.standard_normal((B, S, 4, H, Dh), dtype=np.float32)
    gx[:, 0, 2] = 30.0
    gx[:, 0, 1, :, :Dh // 2] = 0.5
    gx[:, 0, 1, :, Dh // 2:] = -200.0
    r = rng.standard_normal((H, Dh, 4 * Dh), dtype=np.float32) / np.sqrt(Dh)
    s = state_arrays(rng, B, H, Dh)
    s[0][:] = 0.0
    s[2][:] = 0.0
    s[3][:] = 0.5
    return gx, r, s


def op_inputs(case):
    """(gates_x, r, state or None, dhs, dfinal) for a case of
    ``test_slstm_scan_bwd_torch_vs_autograd``."""
    B, H, Dh = 2, 2, 8
    S = {"f32": 7, "f32_state": 5, "bf16_state": 6, "ties": 4,
         "decode": 1}[case]
    rng = np.random.default_rng(len(case) * 7 + S)
    if case == "ties":
        gx, r, s = tie_inputs(B, S, H, Dh, 31)
    else:
        gx = rng.standard_normal((B, S, 4, H, Dh), dtype=np.float32)
        r = (rng.standard_normal((H, Dh, 4 * Dh), dtype=np.float32)
             / np.sqrt(Dh))
        s = state_arrays(rng, B, H, Dh)
    gx = torch.from_numpy(gx)
    if case == "bf16_state":
        gx = gx.bfloat16()
    state = (None if case == "f32"
             else tuple(torch.from_numpy(a.copy()) for a in s))
    dhs = torch.from_numpy(rng.standard_normal((B, S, H, Dh),
                                               dtype=np.float32))
    dfinal = tuple(torch.from_numpy(rng.standard_normal((B, H, Dh),
                                                        dtype=np.float32))
                   for _ in range(4))
    if case == "f32":
        dfinal = (dfinal[0], None, dfinal[2], None)
    return gx, torch.from_numpy(r), state, dhs, dfinal


@pytest.mark.parametrize("case", ["f32", "f32_state", "bf16_state", "ties",
                                  "decode"])
def test_slstm_scan_bwd_torch_vs_autograd(case):
    """The hand-derived reverse-time loop gives autograd's cotangents of
    the plain loop: the gates' (in their dtype), r's and the initial
    state's, for cotangents of hs and of the final state (two of the
    four None in ``f32``), within 1e-5; its saved layout's last slot is
    the final state."""
    gx, r, state, dhs, dfinal = op_inputs(case)
    stack = torch.float32
    leaves = [gx.clone().requires_grad_(), r.clone().requires_grad_()]
    st = (None if state is None
          else tuple(t.clone().requires_grad_() for t in state))
    hs, fin = sl.slstm_scan_torch(leaves[0], leaves[1], st,
                                  stack_dtype=stack)
    outs = [hs] + [f for f, d in zip(fin, dfinal) if d is not None]
    cots = [dhs] + [d for d in dfinal if d is not None]
    ins = leaves + list(st or ())
    want = torch.autograd.grad(outs, ins, cots)
    dgx, dr, d0 = sl.slstm_scan_bwd_torch(gx, r, state, dhs, dfinal)
    assert dgx.dtype == gx.dtype and dgx.shape == gx.shape
    held(dgx, want[0], 1e-5, "gates_x")
    held(dr, want[1], 1e-5, "r")
    if state is not None:
        for name, g, w in zip("hcnm", d0, want[2:]):
            held(g, w, 1e-5, f"d{name}0")
    G, states = sl.slstm_saved_torch(gx, r, state)
    B, S, _, H, Dh = gx.shape
    assert G.shape == (H, S, B, 4 * Dh) and states.shape == (4, H, S + 1,
                                                             B, Dh)
    for k in range(4):
        assert torch.equal(states[k, :, S], fin[k].detach().transpose(0, 1))
    if case == "ties":
        # the first step did tie on half the dims and left n = 0 on the
        # other half
        n1 = states[2, :, 1]
        assert torch.equal(n1[..., :Dh // 2], torch.ones_like(n1[..., :4]))
        assert torch.equal(n1[..., Dh // 2:], torch.zeros_like(n1[..., 4:]))
        assert torch.equal(states[3, :, 1], torch.full_like(n1, 0.5))


# ======================================== the block's cotangents vs JAX

class _PlainBwd(torch.autograd.Function):
    """The plain loop forward, ``slstm_scan_bwd_torch`` backward."""

    @staticmethod
    def forward(ctx, gx, r, h0, c0, n0, m0, stack_dtype):
        state = None if h0 is None else (h0, c0, n0, m0)
        hs, fin = sl.slstm_scan_torch(gx, r, state, stack_dtype=stack_dtype)
        ctx.save_for_backward(gx, r, *(state or ()))
        return (hs.contiguous(), *(f.contiguous() for f in fin))

    @staticmethod
    def backward(ctx, dhs, dh, dc, dn, dm):
        gx, r, *state = ctx.saved_tensors
        dgx, dr, d0 = sl.slstm_scan_bwd_torch(gx, r, state or None, dhs,
                                              (dh, dc, dn, dm))
        return (dgx, dr.to(r.dtype),
                *(d0 if state else (None,) * 4), None)


def block_case(case):
    """Params (JAX's), x, a state and the cotangents for the block."""
    jc, c = block_cfgs()
    H, Dh = c.n_heads, D_MODEL // c.n_heads
    S = {"plain": 11, "ties": 5, "decode": 1}[case]
    jp = jssm.slstm_init(jax.random.PRNGKey(41), D_MODEL, jc, jnp.float32)
    rng = np.random.default_rng(42 + S)
    x = rng.standard_normal((2, S, D_MODEL), dtype=np.float32)
    s = state_arrays(rng, 2, H, Dh)
    if case == "ties":
        # x one-hot at step 0 picks w_gates' row 0 exactly: f = 30 and i
        # = 0.5 or -200 there, with h_{-1} = 0, n0 = 0 and m0 = 0.5 (see
        # tie_inputs)
        w = np.array(jp["w_gates"])
        for h in range(H):
            f = slice(2 * D_MODEL + h * Dh, 2 * D_MODEL + (h + 1) * Dh)
            w[0, f] = 30.0
            w[0, D_MODEL + h * Dh:D_MODEL + h * Dh + Dh // 2] = 0.5
            w[0, D_MODEL + h * Dh + Dh // 2:D_MODEL + (h + 1) * Dh] = -200.0
        jp = dict(jp, w_gates=jnp.asarray(w))
        x[:, 0] = 0.0
        x[:, 0, 0] = 1.0
        s[0][:] = 0.0
        s[2][:] = 0.0
        s[3][:] = 0.5
    dout = rng.standard_normal((2, S, D_MODEL), dtype=np.float32)
    dst = [rng.standard_normal((2, H, Dh), dtype=np.float32)
           for _ in range(4)]
    return jc, c, jp, x, s, dout, dst


def port_grads(c, jp, x, s, dout, dst, plain_bwd):
    """The block's cotangents of x, w_gates, r_gates and the four states:
    the block run from no state with the op handed the test's state, so
    nothing is written in place."""
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for k in ("w_gates", "r_gates"):
        tp[k].requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    st = tuple(torch.from_numpy(a.copy()).requires_grad_() for a in s)
    real = ops.slstm_scan

    def with_state(gx, r, state, *, stack_dtype, impl):
        assert state is None and impl == "auto"
        if plain_bwd:
            hs, *fin = _PlainBwd.apply(gx, r, *st, stack_dtype)
            return hs, tuple(fin)
        return real(gx, r, st, stack_dtype=stack_dtype, impl=impl)

    ops.slstm_scan = with_state
    try:
        out, new = ssm.slstm_fwd(tp, tx, c, D_MODEL)
    finally:
        ops.slstm_scan = real
    ins = [tx, tp["w_gates"], tp["r_gates"], *st]
    return torch.autograd.grad(
        [out, *new["slstm"]], ins,
        [torch.from_numpy(dout)] + [torch.from_numpy(d) for d in dst])


@pytest.mark.parametrize("case", ["plain", "ties", "decode"])
def test_slstm_block_cotangents_vs_jax_vjp(case, monkeypatch):
    """With ``slstm_scan_bwd_torch`` as the op's backward, the block's
    cotangents of x, w_gates, r_gates and the four states: autograd's of
    the plain loop within 1e-5, the reference's ``jax.vjp`` of its
    ``slstm_fwd`` within 1e-4 (the ties split in half in both)."""
    unround(monkeypatch)
    jc, c, jp, x, s, dout, dst = block_case(case)
    got = port_grads(c, jp, x, s, dout, dst, plain_bwd=True)
    auto = port_grads(c, jp, x, s, dout, dst, plain_bwd=False)

    def fwd(w_gates, r_gates, xx, h, cc, n, m):
        p = dict(jp, w_gates=w_gates, r_gates=r_gates)
        out, st = jssm.slstm_fwd(p, xx, jc, D_MODEL,
                                 state={"slstm": (h, cc, n, m)})
        return out, st["slstm"]

    _, vjp = jax.vjp(fwd, jp["w_gates"], jp["r_gates"], jnp.asarray(x),
                     *(jnp.asarray(a) for a in s))
    jw, jr, jx, *jst = vjp((jnp.asarray(dout),
                            tuple(jnp.asarray(d) for d in dst)))
    names = ["x", "w_gates", "r_gates", "dh0", "dc0", "dn0", "dm0"]
    for name, g, a, j in zip(names, got, auto, [jx, jw, jr, *jst]):
        held(g, a, 1e-5, f"{name} against autograd")
        held(g, np.asarray(j), 1e-4, f"{name} against jax.vjp")


# ============================================================== refusals

def test_slstm_scan_kernel_refuses_cpu_tensors_and_unbuilt_widths():
    """``impl="kernel"`` on a CPU tensor raises (no fallback to the plain
    loop); the kernels' wrappers refuse a head width they have no
    instance for before anything else; an unknown impl raises."""
    gx = torch.zeros(1, 3, 4, 2, 16)
    r = torch.zeros(2, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.slstm_scan(gx, r, None, stack_dtype=torch.bfloat16,
                       impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.slstm_scan(gx, r, None, stack_dtype=torch.bfloat16, impl="x")
    with pytest.raises(ValueError, match="head dim 16"):
        sl.slstm_scan_cuda(gx, r)
    with pytest.raises(ValueError, match="head dim 16"):
        sl.slstm_scan_bwd_cuda(r, (None, None), torch.zeros(1, 3, 2, 16),
                               dtype=torch.float32)
    # the width it is built for, on the CPU: the device check refuses it
    gx, r = torch.zeros(1, 3, 4, 2, 256), torch.zeros(2, 256, 1024)
    with pytest.raises(ValueError, match="CUDA"):
        sl.slstm_scan_cuda(gx, r)
    hs, fin = ops.slstm_scan(gx, r, None, stack_dtype=torch.bfloat16)
    assert hs.shape == (1, 3, 2, 256) and hs.dtype == torch.bfloat16
    assert all(t.shape == (1, 2, 256) for t in fin)
