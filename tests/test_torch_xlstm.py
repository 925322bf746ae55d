"""The xLSTM family (xlstm_350m: mLSTM and sLSTM blocks in groups of
``slstm_every``, tied embeddings) in the port against the JAX package, on
the CPU at ``get_smoke("xlstm_350m")``.

Both packages start from the same params (made by the reference's init
functions and moved across with ``interop``) and the same numpy inputs
from a seed; the JAX runs are the reference.  The family has no TPU
kernel (``repro.kernels.ops.mlstm_scan`` is a single ``jnp``
implementation and the sLSTM a ``lax.scan``), so the port's are plain
PyTorch on every device; its RMSNorms are the port's kernel on the card
and its plain version here.

Held: the chunked ``mlstm_scan`` against the reference's sequential
oracle and its chunked scan (several chunks, an S that is no multiple of
the chunk, a given carry) and its gradients against ``jax.vjp``;
``mlstm_decode_step`` stepped against the scan; ``mlstm_fwd`` and
``slstm_fwd`` with and without a state; the whole stack's logits, a
prefill and 5 decode steps (every cache leaf), ``loss_fn``'s value and
every gradient, remat against none bit for bit, 6-step trajectories at
fp32 and int8 moments with 1 and 2 microbatches; the param and cache
trees; the full-size count; the launchers; serve and train checkpoints
crossing the packages; ``chip_smoke.py``'s ``serve_xlstm`` and
``train_xlstm`` at smoke size; the reference's ``slstm_init`` fault,
pinned.

The sLSTM keeps each step's h in bf16 in both packages, whatever the
model's dtype (the reference stacks its scan's outputs in bf16).  In an
fp32 model that rounding turns the two frameworks' last-bit differences
into an occasional one-bf16-step difference (2^-8 of the value) that
later layers carry: the fp32 whole stack's logits then part by 2e-4 to
1.3e-3 of their span, and the reference against itself from params one
ulp apart by 1.2e-3 to 1.8e-3 (read on seeds 12, 3, 8).  So the fp32
whole-stack tests take the rounding out of both packages (``unround``:
the reference module's ``jnp`` seen through a stand-in whose
``bfloat16`` is float32, the port's ``ssm.SLSTM_STACK_DTYPE``), where
they hold at fp32 tolerance (read: 3-5e-6 of the span), and
``test_slstm_bf16_stacking_is_the_references`` holds the rounded path.

Tolerances: fp32 ``atol=1e-5, rtol=1e-4`` (XLA:CPU and ATen sum matmuls
in different orders); the chunked scan against the sequential oracle at
the reference's own ``atol=5e-4, rtol=5e-3`` (the chunked form sums each
chunk's terms in another order and rescales them by exp(m) differences);
bf16 within 2e-2 of the logits' span and of each cache leaf's largest
value, as the hybrid's (``tests/test_torch_models.py``), with silu
rounded op by op as XLA rounds it; trajectories' losses and grad norms
``rtol=1e-4``, params ``atol=2e-5, rtol=1e-4`` with fp32 moments and
``atol=2e-3`` with int8 moments (Adam's eps at 1e-3; int8 grad norms held
step by step from the reference's state, as
``tests/test_torch_moe_train.py`` says why).
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core.block import BlockGrant as JGrant  # noqa: E402
from repro.core.runtime import BlockRuntime as JRuntime  # noqa: E402
from repro.core.runtime import JobSpec as JJob  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jtrain  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402
from repro_torch.core.block import BlockGrant  # noqa: E402
from repro_torch.core.runtime import BlockRuntime, JobSpec  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model, ssm, transformer  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.transformer import flatten  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as train  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

F32_TOL = dict(atol=1e-5, rtol=1e-4)
ORACLE_TOL = dict(atol=5e-4, rtol=5e-3)
ARCH = "xlstm_350m"


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_params(jp):
    return interop.params_from_numpy(np_tree(jp), "cpu")


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               **(tol or F32_TOL))


def cfgs(dtype="float32"):
    """The smoke config in both packages, in ``dtype``."""
    return (jconfigs.get_smoke(ARCH).replace(param_dtype=dtype),
            configs.get_smoke(ARCH).replace(param_dtype=dtype))


@pytest.fixture(scope="module")
def fam():
    """The smoke config, fp32, in both packages, with JAX's params."""
    jcfg, cfg = cfgs()
    return jcfg, cfg, jmodel.init_params(jcfg, jax.random.PRNGKey(3))


def xla_bf16_silu(t):
    """silu with each op rounded to the input's dtype, as XLA:CPU computes
    ``jax.nn.silu`` in bf16 (``tests/test_torch_models.py`` holds it bit
    for bit)."""
    return t * torch.reciprocal(1 + torch.exp(-t))


class _JnpStackingF32:
    """``jax.numpy`` with ``bfloat16`` read as float32 (the reference's
    sLSTM rounds its stacked h with ``h.astype(jnp.bfloat16)``)."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def unround(monkeypatch):
    """Take the sLSTM's bf16 stacking out of both packages (see the
    module docstring)."""
    monkeypatch.setattr(jssm, "jnp", _JnpStackingF32())
    monkeypatch.setattr(ssm, "SLSTM_STACK_DTYPE", torch.float32)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# ================================================================ configs

def test_configs_are_the_references():
    """``get`` and ``get_smoke`` give the reference's configs field for
    field, and the family is ported."""
    for jc, c in ((jconfigs.get(ARCH), configs.get(ARCH)),
                  (jconfigs.get_smoke(ARCH), configs.get_smoke(ARCH))):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert "xlstm" in transformer.PORTED_FAMILIES
    assert configs.get("xlstm-350m").family == "xlstm"


def test_full_size_param_count():
    """0.3887e9 params in 18 leaves, the reference's count to the param
    (``tests/test_models.py``'s published 0.35e9 within its 40%), all
    active (no routed experts)."""
    cfg = configs.get(ARCH)
    n = model.count_params(model.abstract_params(cfg))
    want = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax.eval_shape(lambda: jmodel.init_params(
            jconfigs.get(ARCH), jax.random.PRNGKey(0)))))
    assert n == want == 388_688_896
    assert abs(n / 1e9 - 0.35) / 0.35 < 0.4
    assert model.count_active_params(cfg) == n
    assert len(flatten(model.abstract_params(cfg))) == 18


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_is_the_references(dtype):
    """The port's init builds the reference's tree: the same 18 paths,
    shapes and dtypes (mLSTM leaves stacked (n_groups, k-1, ...), the
    sLSTM's (n_groups, ...))."""
    jcfg, cfg = cfgs(dtype)
    want = {p: (tuple(a.shape), str(a.dtype)) for p, a in flatten(
        jax.eval_shape(lambda: jmodel.init_params(jcfg,
                                                  jax.random.PRNGKey(0))))}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in flatten(model.init_params(cfg, seed=0,
                                                 device="cpu"))}
    assert got == want and len(got) == 18
    assert got["layers/mlstm/blk/wq"][0][:2] == (2, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_tree_is_the_references(dtype):
    """The decode cache has the reference's structure (its tuples kept, so
    a serve checkpoint's tree description is the reference's), shapes and
    initial values (m = -inf for the mLSTM, n = 1 for the sLSTM).  One
    departure: the mLSTM conv tail takes the param dtype, where the
    reference's starts bf16 and its prefill hands back one in the compute
    dtype (the hybrid's choice, ``ssm.mamba2_state_spec``)."""
    jcfg, cfg = cfgs(dtype)
    jc = jmodel.init_cache(jcfg, 2, 16)
    c = model.init_cache(cfg, 2, 16, "cpu")
    _, desc = manager._flatten(c)
    assert desc == str(jax.tree_util.tree_structure(jc))
    want = dict(flatten(np_tree(jc)))
    got = dict(flatten(c))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        w = want[path]
        assert tuple(t.shape) == w.shape, path
        dt = (dtype if path == "mlstm/conv"
              else str(w.dtype))
        assert str(t.dtype).removeprefix("torch.") == dt, path
        assert np.array_equal(t.float().numpy(), w.astype(np.float32)), path
    assert want["mlstm/conv"].dtype == jnp.bfloat16


def test_slstm_init_draws_the_two_ff_leaves_apart():
    """The reference's ``slstm_init`` draws ``w_ff_gate`` and ``w_ff_up``
    from one key, so they start equal (pinned here, the reference
    unedited); the port draws them apart.  Parity tests move params
    across, so they carry the reference's equal pair."""
    jcfg, cfg = cfgs()
    jp = jssm.slstm_init(jax.random.PRNGKey(0), 64, jcfg.xlstm, jnp.float32)
    assert np.array_equal(np.asarray(jp["w_ff_gate"]),
                          np.asarray(jp["w_ff_up"]))
    gen = torch.Generator().manual_seed(0)
    p = ssm.slstm_init(gen, 64, cfg.xlstm, torch.float32, "cpu")
    assert not torch.equal(p["w_ff_gate"], p["w_ff_up"])
    assert p["w_ff_gate"].std() == pytest.approx(p["w_ff_up"].std(),
                                                 rel=0.1)


# ============================================================== mLSTM scan

def mlstm_inputs(B, H, S, Dk, Dv, seed):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, H, S, Dk), dtype=np.float32)
            for _ in range(2))
    v = rng.standard_normal((B, H, S, Dv), dtype=np.float32)
    ig = rng.standard_normal((B, H, S), dtype=np.float32)
    fg = rng.standard_normal((B, H, S), dtype=np.float32) + 2.0
    return q, k, v, ig, fg


def mlstm_carry(B, H, Dk, Dv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Dk, Dv), dtype=np.float32),
            rng.standard_normal((B, H, Dk), dtype=np.float32),
            rng.standard_normal((B, H), dtype=np.float32))


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("chunk", [4, 8, 16, 64])
def test_mlstm_scan_vs_reference_oracle_and_chunked(chunk, carry):
    """Twin of ``tests/test_kernels.py``'s ``test_mlstm_chunked_vs_ref``
    (S = 37, no multiple of any chunk; chunk 64 > S runs one chunk of
    S), from zeros and from a given carry: the port's chunked scan
    against the reference's chunked scan (fp32) and its sequential oracle
    (the oracle's tolerance), and the port's oracle against the
    reference's (fp32)."""
    B, H, S, Dk, Dv = 2, 2, 37, 16, 8
    xs = mlstm_inputs(B, H, S, Dk, Dv, seed=chunk)
    c0 = mlstm_carry(B, H, Dk, Dv, seed=100 + chunk) if carry else None
    jx = [jnp.asarray(a) for a in xs]
    tx = [torch.from_numpy(a) for a in xs]
    jc = None if c0 is None else tuple(jnp.asarray(a) for a in c0)
    tc = None if c0 is None else tuple(torch.from_numpy(a) for a in c0)
    okw = {} if c0 is None else dict(zip(("c0", "n0", "m0"), jc))
    tkw = {} if c0 is None else dict(zip(("c0", "n0", "m0"), tc))
    w_seq = jref.mlstm_scan(*jx, **okw)
    w_chunk = jops.mlstm_scan(*jx, chunk=chunk, carry=jc)
    g_chunk = ops.mlstm_scan(*tx, chunk=chunk, carry=tc)
    g_seq = ref.mlstm_scan(*tx, **tkw)
    for got, want, tol in ((g_chunk, w_chunk, F32_TOL),
                           (g_chunk, w_seq, ORACLE_TOL),
                           (g_seq, w_seq, F32_TOL)):
        assert_close(got[0], want[0], **tol)
        for g, w in zip(got[1], want[1]):
            assert_close(g, w, **tol)


@pytest.mark.parametrize("S", [16, 37])
def test_mlstm_scan_grads_vs_jax_vjp(S):
    """The chunked scan's gradients (q, k, v and both gates, from zeros:
    the carry's m = -inf meets exp in the first chunk) against
    ``jax.vjp`` of the reference's, all finite; the final carry's
    cotangents included."""
    B, H, Dk, Dv, chunk = 2, 2, 8, 8, 8
    xs = mlstm_inputs(B, H, S, Dk, Dv, seed=S)
    rng = np.random.default_rng(S + 1)
    dh = rng.standard_normal((B, H, S, Dv), dtype=np.float32)
    dC, dn = (rng.standard_normal(s, dtype=np.float32)
              for s in ((B, H, Dk, Dv), (B, H, Dk)))

    def jfn(*a):
        h, (C, n, _) = jops.mlstm_scan(*a, chunk=chunk)
        return h, C, n

    _, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in xs])
    want = vjp((jnp.asarray(dh), jnp.asarray(dC), jnp.asarray(dn)))
    tx = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    h, (C, n, _) = ops.mlstm_scan(*tx, chunk=chunk)
    (torch.sum(h * torch.from_numpy(dh)) + torch.sum(C * torch.from_numpy(dC))
     + torch.sum(n * torch.from_numpy(dn))).backward()
    for t, w in zip(tx, want):
        assert bool(torch.isfinite(t.grad).all())
        assert_close(t.grad, w, atol=1e-4, rtol=1e-4)


def test_mlstm_decode_step_matches_the_scan():
    """Twin of ``tests/test_kernels.py``'s
    ``test_mlstm_decode_matches_scan``: the port's decode step, stepped
    from the zero carry (m = -inf), against the port's and the
    reference's sequential scan (the oracle's tolerance), and step by
    step against the reference's decode step (fp32)."""
    B, H, S, Dk, Dv = 1, 2, 9, 8, 8
    xs = mlstm_inputs(B, H, S, Dk, Dv, seed=11)
    jx = [jnp.asarray(a) for a in xs]
    q, k, v, ig, fg = (torch.from_numpy(a) for a in xs)
    h_ref, _ = jref.mlstm_scan(*jx)
    carry = (torch.zeros((B, H, Dk, Dv)), torch.zeros((B, H, Dk)),
             torch.full((B, H), float("-inf")))
    jcarry = (jnp.zeros((B, H, Dk, Dv)), jnp.zeros((B, H, Dk)),
              jnp.full((B, H), -jnp.inf))
    hs = []
    for t in range(S):
        h, carry = ops.mlstm_decode_step(q[:, :, t], k[:, :, t], v[:, :, t],
                                         ig[:, :, t], fg[:, :, t], carry)
        jh, jcarry = jops.mlstm_decode_step(*(a[:, :, t] for a in jx),
                                            jcarry)
        assert_close(h, jh)
        for g, w in zip(carry, jcarry):
            assert_close(g, w)
        hs.append(h)
    hs = torch.stack(hs, 2)
    assert_close(hs, h_ref, **ORACLE_TOL)
    assert_close(hs, ref.mlstm_scan(q, k, v, ig, fg)[0], **ORACLE_TOL)


# ================================================================= blocks

D_MODEL = 32


def block_cfgs():
    jcfg, cfg = cfgs()
    return jcfg.xlstm, cfg.xlstm


@pytest.mark.parametrize("branch", ["no_state", "state_prefill",
                                    "state_decode"])
def test_mlstm_fwd_vs_reference(branch):
    """No state (train): the chunked scan from zeros; a state with S > 1
    (a prefill into a cache): the scan from the carry and the conv tail;
    S == 1 with a state (decode): ``mlstm_decode_step``.  The output and
    the new state, fp32; a given state is written back in place."""
    jc, c = block_cfgs()
    jp = jssm.mlstm_init(jax.random.PRNGKey(6), D_MODEL, jc, jnp.float32)
    tp = interop.params_from_numpy(np_tree(jp), "cpu")
    rng = np.random.default_rng(7)
    S = {"no_state": 37, "state_prefill": 21, "state_decode": 1}[branch]
    x = rng.standard_normal((2, S, D_MODEL), dtype=np.float32)
    jstate = state = None
    if branch != "no_state":
        inner, Dk, Dv, H = ssm._mlstm_dims(D_MODEL, c)
        conv = rng.standard_normal((2, 3, inner), dtype=np.float32)
        carry = mlstm_carry(2, H, Dk, Dv, seed=8)
        jstate = {"conv": jnp.asarray(conv),
                  "mlstm": tuple(jnp.asarray(a) for a in carry)}
        state = {"conv": torch.from_numpy(conv.copy()),
                 "mlstm": tuple(torch.from_numpy(a.copy()) for a in carry)}
    want, wst = jssm.mlstm_fwd(jp, jnp.asarray(x), jc, D_MODEL,
                               state=jstate)
    got, gst = ssm.mlstm_fwd(tp, torch.from_numpy(x), c, D_MODEL,
                             state=state)
    assert_close(got, want)
    assert_close(gst["conv"], wst["conv"])
    for g, w in zip(gst["mlstm"], wst["mlstm"]):
        assert_close(g, w)
    if state is not None:
        assert gst is state                 # written back in place


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_fwd_vs_reference(with_state, dtype):
    """The sLSTM's recurrence from its initial state (n = 1, m = 0) and
    from a given one: the output and (h, c, n, m).  Each step's h is
    kept in bf16 in both, whatever the model's dtype, so the fp32 output
    is held at fp32 tolerance only with that rounding mirrored; bf16
    within 2e-2 of the output's span, silu rounded as XLA rounds it."""
    jc, c = block_cfgs()
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    jp = jssm.slstm_init(jax.random.PRNGKey(9), D_MODEL, jc, jdt)
    tp = interop.params_from_numpy(np_tree(jp), "cpu")
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 23, D_MODEL), dtype=np.float32)
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(x).to(tdt)
    jstate = state = None
    if with_state:
        H, Dh = c.n_heads, D_MODEL // c.n_heads
        s = [rng.standard_normal((2, H, Dh), dtype=np.float32)
             for _ in range(4)]
        s[2] = np.abs(s[2]) + 1.0
        jstate = {"slstm": tuple(jnp.asarray(a) for a in s)}
        state = {"slstm": tuple(torch.from_numpy(a.copy()) for a in s)}
    silu = torch.nn.functional.silu
    if dtype == "bfloat16":
        torch.nn.functional.silu = xla_bf16_silu
    try:
        got, gst = ssm.slstm_fwd(tp, tx, c, D_MODEL, state=state)
    finally:
        torch.nn.functional.silu = silu
    want, wst = jssm.slstm_fwd(jp, jx, jc, D_MODEL, state=jstate)
    if dtype == "float32":
        tol = F32_TOL
    else:
        span = float(np.abs(np.asarray(want, np.float32)).max())
        tol = dict(atol=2e-2 * span, rtol=2e-2)
    assert_close(got, want, **tol)
    for g, w in zip(gst["slstm"], wst["slstm"]):
        assert_close(g, w, **(F32_TOL if dtype == "float32" else dict(
            atol=2e-2 * float(np.abs(np.asarray(w)).max()), rtol=2e-2)))
    if state is not None:
        assert gst is state


# ============================================================ whole stack

def stack_logits(jcfg, cfg, jp, seed=13, S=40):
    """The whole stack's logits on one numpy batch of S tokens, no cache:
    (the port's, the reference's)."""
    tp = port_params(jp)
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, S)).astype(np.int32)
    jx = jmodel.embed_inputs(jp, jcfg, {"tokens": jnp.asarray(tokens)})
    want, _, _ = jmodel.forward(jp, jcfg, jx, positions=jnp.arange(S))
    with torch.no_grad():
        x = model.embed_inputs(tp, cfg, {"tokens": torch.from_numpy(tokens)})
        got, aux, _ = model.forward(tp, cfg, x, positions=torch.arange(S))
    assert float(aux) == 0.0
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_vs_reference(dtype, monkeypatch):
    """The whole stack's logits on a 40-token batch (three chunks of 16,
    the last cut short), no cache: fp32 within 1e-4 of the logits' span
    (the sLSTM's bf16 stacking taken out, ``unround``), bf16 within 2e-2
    with silu rounded as XLA rounds it."""
    if dtype == "bfloat16":
        monkeypatch.setattr(torch.nn.functional, "silu", xla_bf16_silu)
    else:
        unround(monkeypatch)
    jcfg, cfg = cfgs(dtype)
    got, want = stack_logits(jcfg, cfg, jmodel.init_params(
        jcfg, jax.random.PRNGKey(12)))
    span = float(np.abs(want).max())
    rel = 1e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=rel * span, rtol=rel)


@pytest.mark.parametrize("seed", [12, 3])
def test_slstm_bf16_stacking_is_the_references(seed, monkeypatch):
    """The fp32 stack with the sLSTM's bf16 stacking, as both packages run
    it: the port's logits lie within 2e-3 of their span of the
    reference's (read 2.3e-4 and 3.9e-4: one-bf16-step differences of a
    stacked h, the module docstring says why), where the rounding itself
    moves the reference's by more than 4e-3 (read 5.1e-3 and 7.1e-3), so
    a port that left it out would fail."""
    jcfg, cfg = cfgs()
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    got, want = stack_logits(jcfg, cfg, jp)
    unround(monkeypatch)
    _, want_unrounded = stack_logits(jcfg, cfg, jp)
    span = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 2e-3 * span
    assert np.abs(want_unrounded - want).max() > 4e-3 * span


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_steps_vs_reference(dtype, monkeypatch):
    """A prefill of 21 tokens, then five decode steps, against the JAX
    package with the same params: the logits and every cache leaf (the
    mLSTM conv tails and (C, n, m), the sLSTM's (h, c, n, m)).  fp32
    within 1e-4 of the logits' span and of each leaf's largest value,
    with the sLSTM's bf16 stacking taken out (``unround``); bf16 within
    2e-2 of them, silu rounded as XLA rounds it."""
    if dtype == "bfloat16":
        monkeypatch.setattr(torch.nn.functional, "silu", xla_bf16_silu)
    else:
        unround(monkeypatch)
    jcfg, cfg = cfgs(dtype)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(8))
    tp = port_params(jp)
    rng = np.random.default_rng(9)
    B, P = 2, 21
    prompt = rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)
    jcache = jmodel.init_cache(jcfg, B, 32)
    cache = model.init_cache(cfg, B, 32, "cpu")
    wl, jcache = jmodel.prefill(jp, jcfg, {"tokens": jnp.asarray(prompt)},
                                jcache)
    gl, cache = model.prefill(tp, cfg, {"tokens": torch.from_numpy(prompt)},
                              cache)
    rel = 1e-4 if dtype == "float32" else 2e-2

    def check(gl, wl):
        span = float(np.abs(np.asarray(wl, np.float32)).max())
        assert_close(gl, wl, atol=rel * span, rtol=rel)
        want = dict(flatten(np_tree(jcache)))
        got = dict(flatten(cache))
        assert sorted(got) == sorted(want) == [
            "mlstm/conv", "mlstm/mlstm/0", "mlstm/mlstm/1", "mlstm/mlstm/2",
            "slstm/slstm/0", "slstm/slstm/1", "slstm/slstm/2",
            "slstm/slstm/3"]
        for k, v in got.items():
            w = np.asarray(want[k], np.float32)
            assert tuple(v.shape) == w.shape, k
            assert_close(v, w, atol=rel * float(np.abs(w).max()), rtol=rel)

    check(gl, wl)
    tok = np.argmax(np.asarray(wl, np.float32), -1).astype(np.int32)[:, None]
    for i in range(5):
        wl, jcache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jcache,
                                        jnp.int32(P + i))
        gl, cache = model.decode_step(tp, cfg, torch.from_numpy(tok), cache,
                                      torch.tensor(P + i, dtype=torch.int32))
        check(gl, wl)
        tok = np.argmax(np.asarray(wl, np.float32),
                        -1).astype(np.int32)[:, None]


def test_decode_consistency():
    """Prefill + token-by-token decode == one full causal forward (the
    port alone, fp32), as the reference's ``test_decode_consistency``."""
    _, cfg = cfgs()
    params = model.init_params(cfg, seed=10, device="cpu")
    rng = np.random.default_rng(11)
    B, S = 2, 24
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    with torch.no_grad():
        x = model.embed_inputs(params, cfg, {"tokens": tokens})
        full, _, _ = model.forward(params, cfg, x, positions=torch.arange(S))
    P = S - 4
    cache = model.init_cache(cfg, B, S, "cpu")
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


def test_paged_plane_is_refused():
    """The recurrent state does not page, as in the reference."""
    _, cfg = cfgs()
    with pytest.raises(ValueError, match="paged decode unsupported"):
        model.check_paged_support(cfg)
    with pytest.raises(ValueError, match="paged decode unsupported"):
        BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0),
                     JobSpec(cfg, ShapeConfig("s", "serve", 16, 1),
                             kind="serve", paged=True), devices=["cpu"])


# ================================================================ training

def batch_of(cfg, seq=32, batch=2, seed=5):
    return pipeline.synthetic_batch(cfg, ShapeConfig("t", "train", seq,
                                                     batch),
                                    step=0, seed=seed)


def torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def test_loss_fn_value_and_every_grad_vs_reference(fam, monkeypatch):
    """``loss_fn``'s value and every leaf's gradient (the mLSTM's
    ``w_if`` through both gates, ``conv_w``, the sLSTM's recurrent
    ``r_gates`` and both feed-forward leaves among them) against
    ``jax.value_and_grad`` of the reference's, through the checkpointed
    groups, fp32 (the sLSTM's bf16 stacking taken out, ``unround``); the
    mLSTM starts each sequence from m = -inf and every gradient is
    finite."""
    unround(monkeypatch)
    jcfg, cfg, jp = fam
    nb = batch_of(cfg)

    def jloss(p):
        return jmodel.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in nb.items()})[0]

    want_l, want_g = jax.value_and_grad(jloss)(jp)
    state = train.make_train_state(cfg, 0, opt.OptConfig(),
                                   params=port_params(jp), device="cpu")
    got_l, got_g = train.value_and_grad(state["params"], cfg,
                                        torch_batch(nb))
    np.testing.assert_allclose(float(got_l), float(want_l), **F32_TOL)
    want_flat, got_flat = dict(flatten(np_tree(want_g))), dict(flatten(got_g))
    assert set(got_flat) == set(want_flat) and len(got_flat) == 18
    for path, g in got_flat.items():
        assert bool(torch.isfinite(g).all()), path
        assert float(g.abs().max()) > 0, path
        np.testing.assert_allclose(g.numpy(), want_flat[path], err_msg=path,
                                   **F32_TOL)


def test_remat_gives_the_grads_of_the_plain_forward_bit_for_bit(fam):
    """``remat="full"`` recomputes each group (the sLSTM's loop and the
    mLSTM's chunks among it) in the backward: the loss and every grad are
    those of the forward without remat, bit for bit."""
    _, cfg, jp = fam
    assert cfg.remat != "none"
    nb = torch_batch(batch_of(cfg))
    out = []
    for remat in ("full", "none"):
        c = dataclasses.replace(cfg, remat=remat)
        st = train.make_train_state(c, 0, opt.OptConfig(),
                                    params=port_params(jp), device="cpu")
        out.append(train.value_and_grad(st["params"], c, nb))
    assert float(out[0][0]) == float(out[1][0])
    for (p, a), (_, b) in zip(flatten(out[0][1]), flatten(out[1][1])):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("bits", [None, 8])
@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_six_steps_vs_reference(fam, bits, microbatch,
                                           monkeypatch):
    """6 steps of ``make_train_step`` from identical params and optimizer
    state on the same ``DataIterator`` batches, free-running, fp32 (the
    sLSTM's bf16 stacking taken out, ``unround``): losses and learning
    rates at rtol 1e-4, the final params within the module docstring's
    tolerance; with fp32 moments the grad norms at rtol 1e-4 too.

    lr is 3e-3, as the hybrid's (``tests/test_torch_hybrid_train.py``):
    at 1e-2 this trajectory is chaotic, and the reference against itself
    from params moved by one ulp parts after 6 steps by 7.3e-4 in the
    grad norm with fp32 moments (4.8e-4 with 2 microbatches); at 3e-3 by
    1.3e-5 and 1.5e-5.  With int8 moments a last-bit difference can move
    a moment across a code boundary, and the reference against itself
    parts by 1.3e-4 (8.3e-4 with 2 microbatches) in the grad norm at 3e-3
    too, so each step's loss and grad norm are also held at rtol 1e-4
    from the reference's own state (the port's step on the reference's
    params and moments), and the free-running grad norms within the
    reference's own spread from params moved by one ulp."""
    unround(monkeypatch)
    jcfg, cfg, jp = fam
    kw = dict(lr=3e-3, warmup_steps=2, total_steps=20, eps=1e-3,
              state_bits=bits)
    jo, o = jopt.OptConfig(**kw), opt.OptConfig(**kw)
    shape_kw = dict(seq_len=16, global_batch=4, microbatch=microbatch)
    jshape, shape = JShape("t", "train", **shape_kw), \
        ShapeConfig("t", "train", **shape_kw)
    jstate = {"params": jp, "opt": jopt.init(jp, jo)}
    jp_ulp = jax.tree.map(lambda a: jnp.nextafter(a, jnp.inf), jp)
    jstate_ulp = {"params": jp_ulp, "opt": jopt.init(jp_ulp, jo)}

    def port_state(js):
        st = train.make_train_state(cfg, 0, o, params=port_params(
            js["params"]), device="cpu")
        st["opt"] = interop.opt_state_from_numpy(np_tree(js["opt"]), "cpu")
        return st

    state = port_state(jstate)
    jstep = jax.jit(jtrain.make_train_step(jcfg, jshape, jo))
    step = train.make_train_step(cfg, shape, o)
    jdata = jpipeline.DataIterator(jcfg, jshape, seed=1)
    data = pipeline.DataIterator(cfg, shape, seed=1, device="cpu")
    keys = ("loss", "grad_norm", "lr")
    want, got, forced, ulp = [], [], [], []
    for i in range(6):
        b, jb = data.batch(i), jdata.batch(i)
        for k in jb:
            assert np.array_equal(b[k].numpy(), np.asarray(jb[k])), k
        if bits == 8:
            _, m = step(port_state(jstate), b)
            forced.append([float(m[k]) for k in keys])
            jstate_ulp, jm = jstep(jstate_ulp, jb)
            ulp.append(float(jm["grad_norm"]))
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        want.append([float(jm[k]) for k in keys])
        got.append([float(m[k]) for k in keys])
    want, got = np.asarray(want), np.asarray(got)
    if bits == 8:
        np.testing.assert_allclose(np.asarray(forced), want, rtol=1e-4)
        dist = np.abs(got[:, 1] / want[:, 1] - 1).max()
        spread = np.abs(np.asarray(ulp) / want[:, 1] - 1).max()
        assert dist <= spread, (dist, spread)
        got, want = got[:, [0, 2]], want[:, [0, 2]]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    tol = dict(atol=2e-3) if bits == 8 else dict(atol=2e-5, rtol=1e-4)
    want_p = dict(flatten(np_tree(jstate["params"])))
    for path, leaf in flatten(state["params"]):
        np.testing.assert_allclose(leaf.detach().numpy(), want_p[path],
                                   err_msg=path, **tol)
    assert int(state["opt"]["step"]) == 6


def test_train_runtime_matches_reference(fam, tmp_path, monkeypatch):
    """``BlockRuntime(kind="train")`` from the reference block's state,
    fp32 moments: ``step`` and the in-flight window give its losses, grad
    norms and learning rates, step for step (``unround``)."""
    unround(monkeypatch)
    jcfg, cfg, _ = fam
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    shape_kw = dict(seq_len=16, global_batch=2)
    jjob = JJob(jcfg, JShape("t", "train", **shape_kw), kind="train",
                opt=jopt.OptConfig(**kw), seed=2, collect_metrics=True)
    job = JobSpec(cfg, ShapeConfig("t", "train", **shape_kw), kind="train",
                  opt=opt.OptConfig(**kw), seed=2, collect_metrics=True)
    jrt = JRuntime(JGrant.new([(0, 0, 0)], (1, 1), 60.0), jjob,
                   [jax.devices()[0]], str(tmp_path / "ckpt"))
    jrt.init_state()
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), job,
                      devices=["cpu"])
    st = np_tree(jrt.state)
    rt.init_state(params=port_params(st["params"]),
                  opt_state=interop.opt_state_from_numpy(st["opt"], "cpu"))
    for _ in range(2):
        want, got = jrt.step(), rt.step()
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    for r in (jrt, rt):
        r.dispatch()
    want, got = jrt.drain(), rt.drain()
    assert len(got) == len(want) == 1 and rt.inflight_depth == 0
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-4)
    assert rt.step_count == jrt.step_count == 3


# ============================================================ launchers

def fp32_smoke(monkeypatch):
    """Both launchers' ``--smoke`` config made fp32."""
    get_smoke = configs.get_smoke
    monkeypatch.setattr(configs, "get_smoke", lambda a: dataclasses.replace(
        get_smoke(a), param_dtype="float32"))


def test_launcher_serves_the_references_greedy_tokens(monkeypatch, capsys):
    """``launch.serve --arch xlstm_350m --smoke --device cpu`` emits the
    tokens the reference's greedy prefill and decode give on the
    launcher's params and prompts (fp32, ``unround``: in bf16, or with
    the bf16 stacking, a near tie can flip an argmax)."""
    unround(monkeypatch)
    fp32_smoke(monkeypatch)
    args = launch_serve.parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "20", "--gen", "8"])
    res = launch_serve.run(args)
    assert res["cfg"].family == "xlstm"
    rt = res["runtime"]
    assert rt.cache_len == 27 and set(rt.cache) == {"mlstm", "slstm"}
    jcfg = jconfigs.get_smoke(ARCH).replace(param_dtype="float32")
    jp = jax.tree.map(jnp.asarray, interop.params_to_numpy(
        rt.state["params"]))
    prompt = jnp.asarray(res["batch"]["tokens"])
    logits, cache = jmodel.prefill(jp, jcfg, {"tokens": prompt},
                                   jmodel.init_cache(jcfg, 2, 28))
    want = []
    for i in range(8):
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        want.append(tok)
        if i < 7:
            logits, cache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok),
                                               cache, jnp.int32(20 + i))
    assert np.array_equal(res["tokens"], np.concatenate(want, 1))
    assert launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                              "--batch", "2", "--prompt-len", "16",
                              "--gen", "3"]) == 0
    assert "xlstm_350m_smoke" in capsys.readouterr().out


def test_launcher_trains_as_the_reference(monkeypatch, capsys):
    """``launch.train --arch xlstm_350m --smoke --device cpu``: its losses
    are the reference's train step's from the launcher's own initial
    params on the same batches and optimizer settings (fp32,
    ``unround``)."""
    unround(monkeypatch)
    fp32_smoke(monkeypatch)
    captured = {}
    init_state = BlockRuntime.init_state

    def capture(self, params=None, opt_state=None):
        init_state(self, params, opt_state)
        captured["params"] = jax.tree.map(
            np.array, interop.params_to_numpy(self.state["params"]))

    monkeypatch.setattr(BlockRuntime, "init_state", capture)
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--seq-len", "16", "--global-batch", "2", "--log-every", "1",
            "--seed", "4"]
    res = launch_train.run(launch_train.parse_args(argv))
    assert res["cfg"].family == "xlstm"
    got = [h["loss"] for h in res["history"]]
    jcfg = jconfigs.get_smoke(ARCH).replace(param_dtype="float32")
    jp = jax.tree.map(jnp.asarray, captured["params"])
    jo = jopt.OptConfig(lr=3e-4, warmup_steps=1, total_steps=3)
    jshape = JShape("cli", "train", seq_len=16, global_batch=2,
                    microbatch=1)
    jstate = {"params": jp, "opt": jopt.init(jp, jo)}
    jstep = jax.jit(jtrain.make_train_step(jcfg, jshape, jo))
    jdata = jpipeline.DataIterator(jcfg, jshape, seed=4)
    want = []
    for i in range(3):
        jstate, jm = jstep(jstate, jdata.batch(i))
        want.append(float(jm["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert launch_train.main(argv[:-2]) == 0
    out = capsys.readouterr().out
    assert "xlstm_350m_smoke" in out and "# done:" in out


# ============================================================ checkpoints

def leaf_bits(tree):
    """[(dtype, shape, bytes)] of every leaf in ``jax.tree`` order (dicts
    by sorted key, tuples in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_bits(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in leaf_bits(t)]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        return [(str(t.dtype).removeprefix("torch."), tuple(t.shape),
                 t.reshape(-1).view(torch.uint8).numpy().tobytes())]
    a = np.asarray(tree)
    return [(str(a.dtype), a.shape, a.tobytes())]


def block_pair(kind, root, jcfg, cfg):
    """Constructors of the reference's and the port's block for one job
    (fp32, the same namespace under ``root``)."""
    shape_kw = dict(seq_len=16, global_batch=2)
    ns = f"xlstm_{kind}"
    if kind == "train":
        kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
        jjob = JJob(jcfg, JShape("t", "train", **shape_kw), kind="train",
                    opt=jopt.OptConfig(**kw), ckpt_namespace=ns)
        job = JobSpec(cfg, ShapeConfig("t", "train", **shape_kw),
                      kind="train", opt=opt.OptConfig(**kw),
                      ckpt_namespace=ns)
    else:
        jjob = JJob(jcfg, JShape("s", "serve", **shape_kw), kind="serve",
                    ckpt_namespace=ns)
        job = JobSpec(cfg, ShapeConfig("s", "serve", **shape_kw),
                      kind="serve", ckpt_namespace=ns)
    return (lambda: JRuntime(JGrant.new([(0, 0, 0)], (1, 1), 60.0), jjob,
                             [jax.devices()[0]], root),
            lambda: BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0),
                                 job, devices=["cpu"], ckpt_root=root))


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("kind", ["train", "serve"])
def test_checkpoint_crosses_packages(kind, writer, tmp_path, monkeypatch):
    """One package saves an xlstm block, the other restores it leaf for
    leaf and bit for bit, and both step on alike (fp32, ``unround``): a
    train block after 2 steps (then 2 more steps, the same losses, grad
    norms and learning rates), a serve block after a prefill and 3
    decode steps (its recurrent cache, the reference's tuples kept; then
    3 more decode steps, the same tokens)."""
    unround(monkeypatch)
    jcfg, cfg = cfgs()
    first, second = block_pair(kind, str(tmp_path), jcfg, cfg)
    if writer == "port":
        first, second = second, first
    a = first()
    a.init_state()
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    if kind == "serve":
        a.prefill({"tokens": prompt})
    for _ in range(2 if kind == "train" else 3):
        a.step()
    a.save(async_=False)
    b = second()
    assert b.restore() == a.step_count
    jrt, rt = (a, b) if writer == "reference" else (b, a)
    if kind == "train":
        assert leaf_bits(rt.state) == leaf_bits(np_tree(jrt.state))
        for _ in range(2):
            want, got = jrt.step(), rt.step()
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
        return
    got, want = leaf_bits(rt.cache), leaf_bits(np_tree(jrt.cache))
    if writer == "port":
        # the reference restores into its own target, whose conv tail is
        # bf16 (the departure ``test_cache_tree_is_the_references`` names):
        # the port's fp32 tail comes back rounded
        conv = rt.cache["mlstm"]["conv"].to(torch.bfloat16)
        got[0] = leaf_bits(conv)[0]
    assert got == want
    assert isinstance(rt.cache["mlstm"]["mlstm"], tuple)
    assert rt.cache_len == int(jrt.cache_len) == 12
    for _ in range(3):
        jrt.step(), rt.step()
        assert np.array_equal(rt.token.numpy(), np.asarray(jrt.token))


# ======================================================= chip_smoke's phases

def test_chip_smoke_serve_xlstm_rehearses_on_cpu():
    """``chip_smoke.py``'s ``serve_xlstm`` at smoke size on the CPU (the
    plain versions run on both sides, so every distance is 0; no kernel
    launches), and the launches it holds the card to at full size: 49
    RMSNorms a prefill and a decode step (3 groups of 8 sublayers, 2
    each, and the final norm), 3 sLSTM recurrences (one a group) and 21
    mLSTM chunked scans a prefill (none a decode step, whose update is
    plain PyTorch)."""
    smoke = _chip_smoke()
    out = smoke.phase_serve_xlstm(device="cpu", smoke=True)
    assert out["arch"] == "xlstm_350m_smoke"
    for chk in (out["logits_check"], out["first_decode_logits_check"]):
        assert chk["f32"]["passed"] and chk["f32"]["max_abs_err"] == 0.0
        assert chk["bf16_whole_stack"]["max_abs_err"] == 0.0
    subs = out["bf16_sublayer_check"]
    assert len(subs["prefill"]) == len(subs["decode"]) == 4
    assert subs["worst"] == {"prefill": 0.0, "decode": 0.0}
    assert all(r["update_range"] > 0 and r["finite"]
               for r in subs["prefill"] + subs["decode"])
    assert out["captured_vs_eager"]["tokens_equal"]
    assert set(out["launches"].values()) == {0}
    pre, dec = smoke.xlstm_launches(configs.get(ARCH))
    assert {k for k, v in pre.items() if v} == {
        "rmsnorm", "slstm_scan", "mlstm_scan"}
    assert pre["rmsnorm"] == 49 and pre["slstm_scan"] == 3
    assert pre["mlstm_scan"] == 21
    assert dec == {**pre, "mlstm_scan": 0}


def test_chip_smoke_xlstm_sublayer_check_catches_a_bf16_fault(monkeypatch):
    """The bf16 sublayer check fails when the RMSNorm kernel goes wrong in
    bf16 only (one column's scale dropped on the kernels' side), where
    the fp32 whole-stack check cannot see it."""
    smoke = _chip_smoke()
    real = ops.rmsnorm

    def faulty(x, scale, *, eps=1e-6, impl="auto"):
        y = real(x, scale, eps=eps, impl=impl)
        if impl != "torch" and y.dtype == torch.bfloat16:
            y = y.clone()
            y[..., 0] = y[..., 0] / scale[0].clamp_min(1e-3) * 3.0
        return y

    monkeypatch.setattr(ops, "rmsnorm", faulty)
    with pytest.raises(SystemExit, match="xlstm bf16 sublayers"):
        smoke.phase_serve_xlstm(device="cpu", smoke=True)


def test_chip_smoke_train_xlstm_rehearses_on_cpu():
    """``chip_smoke.py``'s ``train_xlstm`` at smoke size on the CPU: step
    0 in fp32 against ``impl="torch"`` (the same plain path here) and the
    bf16 step 0 read beside it, 2 steps, no kernel launched; at full size
    the card is held to 97 RMSNorms forward (with remat's recompute), 49
    backward, 42 mLSTM chunked scans forward (with the recompute) and 21
    backward, 6 sLSTM recurrences forward and 3 backward, and 18 fp32
    AdamW updates a step, 3 of them on the scalar route (``w_if``, 8
    wide, ``w_ff_gate`` and ``w_ff_up``, 1365)."""
    smoke = _chip_smoke()
    out = smoke.phase_train_xlstm(device="cpu", smoke=True)
    assert out["arch"] == "xlstm_350m_smoke" and out["steps"] == 2
    chk = out["step0_check"]
    assert chk["f32"]["within_rtol"] and chk["f32"]["loss_rel_err"] == 0.0
    assert "within_limit_read" in chk["bf16_vs_f32"]
    assert set(out["launches"].values()) == {0}
    assert all(np.isfinite(out["losses"]))
    cfg = configs.get(ARCH)
    want = smoke.train_launches(
        cfg, ShapeConfig("c", "train", 2048, 4, 1),
        opt.OptConfig(state_bits=None), model.abstract_params(cfg))
    assert {k: v for k, v in want.items() if v} == {
        "rmsnorm": 97, "rmsnorm_bwd": 49, "slstm_scan": 6,
        "slstm_scan_bwd": 3, "mlstm_scan": 42, "mlstm_scan_bwd": 21,
        "fused_adamw_f32": 18, "fused_adamw_scalar": 3}
