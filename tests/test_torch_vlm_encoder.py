"""The VLM (pixtral_12b: mistral_nemo_12b's backbone behind the patch
stub) and the encoder (hubert_xlarge: LayerNorm, a plain GELU MLP,
bidirectional MHA, the frame stub, the masked-frame loss) in the port
against the JAX package, on the CPU at ``get_smoke``.

Both packages start from the same params (made by the reference's
``init_params`` and moved across with ``interop``) and the same numpy
batches (``data.pipeline.synthetic_batch``); the JAX runs are the
reference.  Held: the param tree, ``embed_inputs`` with and without
``mask``/``patches``, ``loss_fn`` and every leaf's gradient, 6-step
trajectories with fp32 moments, pixtral's prefill and 5 decode steps at
``cache_len = n_patches + T + i``, both launchers, the train runtime and
checkpoints crossing the packages, and the port's one departure: its
runtime decodes a VLM after the patches and the text, where the
reference's runtime sets ``cache_len = T`` after a patch prefill.

Tolerances, as ``tests/test_torch_models.py`` and
``tests/test_torch_train.py`` have them, each with its reason there:
fp32 ``atol=1e-5, rtol=1e-4``; trajectories' losses and grad norms
``rtol=1e-4``, params ``atol=2e-5, rtol=1e-4``; bf16 activations
``atol=rtol=2e-2`` scaled by their range.
"""
import dataclasses

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
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.config import ShapeConfig as JShape  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jtrain  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.block import BlockGrant  # noqa: E402
from repro_torch.core.runtime import BlockRuntime, JobSpec  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import hlo_analysis  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.transformer import flatten  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as train  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

F32_TOL = dict(atol=1e-5, rtol=1e-4)
ARCHS = ("pixtral_12b", "hubert_xlarge")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_params(jp):
    return interop.params_from_numpy(np_tree(jp), "cpu")


def cfgs(arch, dtype="float32"):
    return (jconfigs.get_smoke(arch).replace(param_dtype=dtype),
            configs.get_smoke(arch).replace(param_dtype=dtype))


@pytest.fixture(scope="module", params=ARCHS)
def fam(request):
    """One family's smoke config, fp32, in both packages, with JAX's
    params."""
    jcfg, cfg = cfgs(request.param)
    return jcfg, cfg, jmodel.init_params(jcfg, jax.random.PRNGKey(3))


def batch_of(cfg, seq=32, batch=2, step=0, seed=5):
    return pipeline.synthetic_batch(cfg, ShapeConfig("t", "train", seq,
                                                     batch),
                                    step=step, seed=seed)


def assert_close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32),
                               **(tol or F32_TOL))


# ============================================================ configs, tree

def test_configs_are_ported(monkeypatch):
    """Both archs resolve in the port (the reference's configs, verbatim:
    ``tests/test_torch_package.py``), and so does xlstm now; an arch
    marked not ported (a stand-in entry in ``configs._NOT_PORTED``)
    raises."""
    for arch in ARCHS + ("xlstm_350m",):
        for get, jget in ((configs.get, jconfigs.get),
                          (configs.get_smoke, jconfigs.get_smoke)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
                jget(arch))
    assert configs.get("pixtral_12b").family == "vlm"
    assert configs.get("hubert_xlarge").family == "encoder"
    assert configs.get("xlstm_350m").family == "xlstm"
    monkeypatch.setitem(configs._NOT_PORTED, "pixtral_12b", "vlm")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        configs.get("pixtral_12b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + ("deepseek_v2_236b",
                                          "llama4_maverick_400b"))
def test_init_params_tree_is_the_references(arch, dtype):
    """The port's own init draws the reference's tree (keys, shapes,
    dtypes): the frame frontend has ``frame_proj`` and ``mask_embed`` and
    no ``embed``, the patch frontend adds ``patch_proj``, LayerNorm leaves
    have ``scale`` and ``bias``, the moe family has MLA's leaves or the
    ``{dense, moe}`` halves, stacked experts and an fp32 router; JAX
    params cross to the port and back bit for bit; both count the same
    active params (the routed-expert discount among them)."""
    jcfg, cfg = cfgs(arch, dtype)
    jp = np_tree(jmodel.init_params(jcfg, jax.random.PRNGKey(1)))
    want = {p: (tuple(a.shape), np.dtype(a.dtype).name)
            for p, a in flatten(jp)}
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in flatten(model.init_params(cfg, device="cpu"))}
    assert got == want
    if cfg.frontend == "frame":
        assert "embed" not in got and {"frame_proj", "mask_embed"} <= set(got)
        assert {"layers/ln1/scale", "layers/ln1/bias",
                "final_norm/bias"} <= set(got)
    elif cfg.frontend == "patch":
        assert {"embed", "patch_proj"} <= set(got)
    elif cfg.attention.is_mla:
        assert {"embed", "layers/attn/wkv_a", "layers/attn/kv_norm",
                "layers/moe/w_gate"} <= set(got)
        assert got["layers/moe/router"][1] == "float32"
    else:
        assert {"layers/dense/mlp/w_up", "layers/moe/moe/w_down",
                "layers/moe/moe/shared/w_gate"} <= set(got)
        assert got["layers/moe/moe/router"][1] == "float32"
    back = interop.params_to_numpy(port_params(jp))
    for path, a in flatten(jp):
        b = dict(flatten(back))[path]
        assert b.dtype == a.dtype and b.tobytes() == a.tobytes(), path
    assert model.count_active_params(cfg) == jmodel.count_active_params(jcfg)
    assert (model.count_active_params(configs.get(arch))
            == jmodel.count_active_params(jconfigs.get(arch)))


# ============================================================ embed_inputs

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["frames", "frames_masked", "tokens",
                                  "tokens_patches"])
def test_embed_inputs_vs_reference(case, dtype):
    """The stubs' projections as ``jnp`` computes them: the inputs
    rounded to bf16, then the product in the weights' dtype (fp32 with
    fp32 params: ``jnp`` promotes the bf16 operand; bf16 with bf16
    params), ``mask_embed`` at the masked frames, the patches in front of
    the token embeddings."""
    arch = "hubert_xlarge" if case.startswith("frames") else "pixtral_12b"
    jcfg, cfg = cfgs(arch, dtype)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(2))
    nb = batch_of(cfg)
    keep = {"frames": ("frames",), "frames_masked": ("frames", "mask"),
            "tokens": ("tokens",), "tokens_patches": ("tokens", "patches")}
    nb = {k: v for k, v in nb.items() if k in keep[case]}
    want = np.asarray(jmodel.embed_inputs(
        jp, jcfg, {k: jnp.asarray(v) for k, v in nb.items()})
        .astype(jnp.float32))
    got = model.embed_inputs(port_params(jp), cfg,
                             {k: torch.from_numpy(v) for k, v in nb.items()})
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    if case == "tokens_patches":
        assert got.shape[1] == nb["tokens"].shape[1] + nb["patches"].shape[1]
    if case == "frames_masked":
        m = nb["mask"]
        assert m.any() and not m.all()
        np.testing.assert_array_equal(np.asarray(got.float())[m], want[m])
    if dtype == "float32":
        assert_close(got, want)
    else:
        span = float(np.abs(want).max())
        assert_close(got, want, atol=2e-2 * span, rtol=2e-2)


# ================================================= hubert's layers, full width

@pytest.mark.parametrize("layer", ["layer_norm", "gelu_mlp",
                                   "bidirectional_attention"])
def test_hubert_layers_at_full_width_vs_reference(layer):
    """hubert_xlarge's own widths (d_model 1280, d_ff 5120, 16 heads of
    80, no causal mask), fp32, a short sequence: LayerNorm (random scale
    and bias), the plain tanh-GELU MLP and the bidirectional attention
    give the reference's numbers; LayerNorm stays plain PyTorch, as the
    reference computes it in ``jnp``."""
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    cfg = configs.get("hubert_xlarge")
    a, d = cfg.attention, cfg.d_model
    assert not a.causal and cfg.norm == "layer" and cfg.act == "gelu"
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 24, d), dtype=np.float32)
    key = jax.random.PRNGKey(6)
    if layer == "layer_norm":
        jp = {"scale": jnp.asarray(rng.standard_normal(d, np.float32)),
              "bias": jnp.asarray(rng.standard_normal(d, np.float32))}
        want = jlayers.apply_norm(jp, jnp.asarray(x), "layer")
        got = layers.apply_norm(port_params(jp), torch.from_numpy(x),
                                "layer")
    elif layer == "gelu_mlp":
        jp = jlayers.mlp_init(key, d, cfg.d_ff, cfg.mlp_gated, jnp.float32)
        want = jlayers.mlp_fwd(jp, jnp.asarray(x), cfg.act, cfg.mlp_gated)
        got = layers.mlp_fwd(port_params(jp), torch.from_numpy(x), cfg.act,
                             cfg.mlp_gated)
    else:
        jp = jlayers.attention_init(key, d, a, jnp.float32)
        want, _ = jlayers.attention_fwd(jp, jnp.asarray(x), a,
                                        positions=jnp.arange(24),
                                        causal=False)
        got, _ = layers.attention_fwd(port_params(jp), torch.from_numpy(x),
                                      a, positions=torch.arange(24),
                                      causal=False)
    assert_close(got, np.asarray(want))


# ============================================================== loss, grads

def test_loss_fn_value_and_every_grad_vs_reference(fam):
    """The masked-frame loss (only the masked frames count) or the
    next-token loss on the text after the patches: the value and every
    leaf's gradient, the stubs' projections and ``mask_embed`` among
    them."""
    jcfg, cfg, jp = fam
    nb = batch_of(cfg)

    def jloss(p):
        return jmodel.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                        for k, v in nb.items()})[0]

    want_l, want_g = jax.value_and_grad(jloss)(jp)
    state = train.make_train_state(cfg, 0, opt.OptConfig(),
                                   params=port_params(jp), device="cpu")
    got_l, got_g = train.value_and_grad(
        state["params"], cfg, {k: torch.from_numpy(v) for k, v in nb.items()})
    np.testing.assert_allclose(float(got_l), float(want_l), **F32_TOL)
    want_flat, got_flat = dict(flatten(np_tree(want_g))), dict(flatten(got_g))
    assert set(got_flat) == set(want_flat)
    stub = "mask_embed" if cfg.frontend == "frame" else "patch_proj"
    assert float(got_flat[stub].abs().max()) > 0
    for path, g in got_flat.items():
        np.testing.assert_allclose(g.numpy(), want_flat[path], err_msg=path,
                                   **F32_TOL)


def test_masked_frame_loss_counts_only_masked_frames():
    """Changing the labels of unmasked frames leaves hubert's loss as it
    is, in both packages."""
    jcfg, cfg = cfgs("hubert_xlarge")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(4))
    nb = batch_of(cfg)
    other = dict(nb, labels=np.where(nb["mask"], nb["labels"],
                                     (nb["labels"] + 1) % cfg.vocab_size))
    p = port_params(jp)
    losses = [float(model.loss_fn(p, cfg, {k: torch.from_numpy(v)
                                            for k, v in b.items()})[0])
              for b in (nb, other)]
    jlosses = [float(jmodel.loss_fn(jp, jcfg, {k: jnp.asarray(v)
                                               for k, v in b.items()})[0])
               for b in (nb, other)]
    assert losses[0] == losses[1] and jlosses[0] == jlosses[1]
    np.testing.assert_allclose(losses[0], jlosses[0], **F32_TOL)


# ============================================================ trajectories

def test_train_step_six_steps_vs_reference(fam):
    """6 steps of ``make_train_step`` with fp32 moments from identical
    params and optimizer state on the same ``DataIterator`` batches
    (frames, bool masks and patches reach the device unchanged): losses,
    grad norms and learning rates at rtol 1e-4, the final params at
    ``atol=2e-5, rtol=1e-4``."""
    jcfg, cfg, jp = fam
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, eps=1e-3,
              state_bits=None)
    jo, o = jopt.OptConfig(**kw), opt.OptConfig(**kw)
    jshape = JShape("t", "train", seq_len=32, global_batch=4)
    shape = ShapeConfig("t", "train", seq_len=32, global_batch=4)
    jstate = {"params": jp, "opt": jopt.init(jp, jo)}
    state = train.make_train_state(cfg, 0, o, params=port_params(jp),
                                   device="cpu")
    state["opt"] = interop.opt_state_from_numpy(np_tree(jstate["opt"]),
                                                "cpu")
    jstep = jax.jit(jtrain.make_train_step(jcfg, jshape, jo))
    step = train.make_train_step(cfg, shape, o)
    jdata = jpipeline.DataIterator(jcfg, jshape, seed=1)
    data = pipeline.DataIterator(cfg, shape, seed=1, device="cpu")
    want, got = [], []
    for i in range(6):
        b, jb = data.batch(i), jdata.batch(i)
        assert set(b) == set(jb)
        for k in jb:
            assert np.array_equal(b[k].numpy(), np.asarray(jb[k])), k
        if cfg.frontend == "frame":
            assert b["mask"].dtype == torch.bool
            assert b["frames"].dtype == torch.float32
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, b)
        want.append([float(jm[k]) for k in ("loss", "grad_norm", "lr")])
        got.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4)
    want_p = dict(flatten(np_tree(jstate["params"])))
    for path, leaf in flatten(state["params"]):
        np.testing.assert_allclose(leaf.detach().numpy(), want_p[path],
                                   err_msg=path, atol=2e-5, rtol=1e-4)
    assert int(state["opt"]["step"]) == 6


# ========================================================= pixtral serving

def reference_greedy(jp, jcfg, batch, n):
    """The reference's model-level greedy decode after a patch prefill, at
    ``cache_len = n_patches + T + i`` (as its own model test decodes):
    the prefill's logits and ``n`` tokens."""
    n_p, T = batch["patches"].shape[1], batch["tokens"].shape[1]
    cache = jmodel.init_cache(jcfg, batch["tokens"].shape[0], n_p + T + n)
    logits, cache = jmodel.prefill(
        jp, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, cache)
    first, toks, steps = np.asarray(logits), [], []
    for i in range(n):
        tok = np.argmax(np.asarray(logits), -1).astype(np.int32)[:, None]
        toks.append(tok)
        if i < n - 1:
            logits, cache = jmodel.decode_step(jp, jcfg, jnp.asarray(tok),
                                               cache,
                                               jnp.int32(n_p + T + i))
            steps.append(np.asarray(logits))
    return first, steps, np.concatenate(toks, 1)


def vlm_prompt(cfg, seq=24, batch=2, seed=3):
    nb = pipeline.synthetic_batch(cfg, ShapeConfig("p", "prefill", seq,
                                                   batch),
                                  step=0, seed=seed)
    return {k: v for k, v in nb.items() if k != "labels"}


def test_pixtral_prefill_and_decode_vs_reference():
    """Prefill of patches + text, then 5 decode steps at cache_len
    n_patches + T + i, every logit against the reference's model-level
    functions."""
    jcfg, cfg = cfgs("pixtral_12b")
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(5))
    p = port_params(jp)
    nb = vlm_prompt(cfg)
    n_p, T = nb["patches"].shape[1], nb["tokens"].shape[1]
    assert n_p == 3 and T == 21
    want_first, want_steps, want_toks = reference_greedy(jp, jcfg, nb, 6)
    cache = model.init_cache(cfg, 2, n_p + T + 6, "cpu")
    logits, cache = model.prefill(p, cfg, {k: torch.from_numpy(v)
                                           for k, v in nb.items()}, cache)
    assert_close(logits, want_first)
    assert model.embedded_len(cfg, nb) == n_p + T
    for i in range(5):
        tok = torch.from_numpy(want_toks[:, i:i + 1])
        logits, cache = model.decode_step(p, cfg, tok, cache, n_p + T + i)
        assert_close(logits, want_steps[i])


def serve_jobs(seq):
    jcfg, cfg = cfgs("pixtral_12b")
    shape = dict(seq_len=seq, global_batch=2)
    return (jcfg, cfg,
            JJob(jcfg, JShape("s", "serve", **shape), kind="serve",
                 ckpt_namespace="v"),
            JobSpec(cfg, ShapeConfig("s", "serve", **shape), kind="serve",
                    ckpt_namespace="v"))


def test_runtime_decodes_after_the_patches_where_the_reference_does_not(
        tmp_path):
    """The one departure.  After a patch prefill the reference's
    ``BlockRuntime`` reads ``cache_len == T`` (so it decodes n_patches
    positions too early); the port's reads ``n_patches + T``, and its
    greedy tokens are the reference's model-level ones at the right
    positions.  Nothing in the reference is changed to show it."""
    jcfg, cfg, jjob, job = serve_jobs(32)
    nb = vlm_prompt(cfg)
    n_p, T = nb["patches"].shape[1], nb["tokens"].shape[1]
    jrt = JRuntime(JGrant.new([(0, 0, 0)], (1, 1), 60.0), jjob,
                   [jax.devices()[0]], str(tmp_path / "j"))
    jrt.init_state()
    jrt.prefill({k: jnp.asarray(v) for k, v in nb.items()})
    assert int(jrt.cache_len) == T                  # the reference's fault
    rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), job,
                      devices=["cpu"])
    rt.init_state(params=port_params(np_tree(jrt.state["params"])))
    rt.prefill(nb)
    assert rt.cache_len == n_p + T
    got = [rt.token.clone()]
    for _ in range(5):
        rt.step()
        got.append(rt.token.clone())
    assert rt.cache_len == n_p + T + 5
    _, _, want = reference_greedy(jrt.state["params"], jcfg, nb, 6)
    assert np.array_equal(torch.cat(got, 1).numpy(), want)


def test_pixtral_serve_suspend_resume_continues(tmp_path):
    """A pixtral serve block: prefill with patches, 3 steps, suspend,
    resume: the cache, token and ``cache_len`` (n_patches + T + 3) bit
    for bit, and 3 more steps give an uninterrupted block's tokens."""
    _, cfg, _, job = serve_jobs(32)
    nb = vlm_prompt(cfg)
    n_p, T = nb["patches"].shape[1], nb["tokens"].shape[1]

    def block(root=None):
        rt = BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), job,
                          devices=["cpu"], ckpt_root=root)
        rt.init_state()
        rt.prefill(nb)
        return rt

    whole, want = block(), []
    for _ in range(6):
        whole.step()
        want.append(whole.token.clone())
    rt, got = block(str(tmp_path)), []
    for _ in range(3):
        rt.step()
        got.append(rt.token.clone())
    before = [t.clone() for _, t in flatten(rt._decode_ctx()["cache"])]
    rt.suspend()
    assert rt.cache is None
    assert rt.resume(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0), ["cpu"]) == 3
    assert rt.cache_len == n_p + T + 3
    after = [t for _, t in flatten(rt._decode_ctx()["cache"])]
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    for _ in range(3):
        rt.step()
        got.append(rt.token.clone())
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def fp32_smoke(monkeypatch):
    get_smoke = configs.get_smoke
    monkeypatch.setattr(configs, "get_smoke", lambda a: dataclasses.replace(
        get_smoke(a), param_dtype="float32"))


def test_launcher_serves_pixtral_as_the_reference_decodes(monkeypatch,
                                                          capsys):
    """``launch.serve --arch pixtral_12b --smoke --device cpu``: its
    greedy tokens are the reference's model-level ones (prefill of the
    patches and the text, decode at n_patches + T + i) on the launcher's
    own params and prompts; the prompt's positions count the patches."""
    fp32_smoke(monkeypatch)
    args = launch_serve.parse_args(
        ["--arch", "pixtral_12b", "--smoke", "--device", "cpu", "--batch",
         "2", "--prompt-len", "24", "--gen", "6"])
    res = launch_serve.run(args)
    rt, batch = res["runtime"], res["batch"]
    assert res["cfg"].family == "vlm" and set(batch) == {"tokens", "patches"}
    n_p, T = batch["patches"].shape[1], batch["tokens"].shape[1]
    assert n_p + T == args.prompt_len and rt.cache_len == 24 + 5
    jcfg = jconfigs.get_smoke("pixtral_12b").replace(param_dtype="float32")
    jp = jax.tree.map(jnp.asarray, interop.params_to_numpy(
        rt.state["params"]))
    _, _, want = reference_greedy(jp, jcfg, batch, 6)
    assert np.array_equal(res["tokens"], want)
    assert launch_serve.main(["--arch", "pixtral_12b", "--smoke", "--device",
                              "cpu", "--batch", "2", "--prompt-len", "16",
                              "--gen", "3"]) == 0
    assert "pixtral_12b_smoke" in capsys.readouterr().out


def test_launcher_refuses_to_serve_the_encoder():
    with pytest.raises(SystemExit, match="encoder-only arch has no decode"):
        launch_serve.run(launch_serve.parse_args(
            ["--arch", "hubert_xlarge", "--smoke", "--device", "cpu"]))


# ============================================================ hubert train

def test_launcher_trains_hubert_as_the_reference(monkeypatch, capsys):
    """``launch.train --arch hubert_xlarge --smoke --device cpu``: its
    losses are the reference's train step's from the launcher's own
    initial params on the same batches and optimizer settings."""
    fp32_smoke(monkeypatch)
    captured = {}
    init_state = BlockRuntime.init_state

    def capture(self, params=None, opt_state=None):
        init_state(self, params, opt_state)
        captured["params"] = jax.tree.map(
            np.array, interop.params_to_numpy(self.state["params"]))

    monkeypatch.setattr(BlockRuntime, "init_state", capture)
    argv = ["--arch", "hubert_xlarge", "--smoke", "--device", "cpu",
            "--steps", "3", "--seq-len", "32", "--global-batch", "2",
            "--log-every", "1", "--seed", "4"]
    res = launch_train.run(launch_train.parse_args(argv))
    assert res["cfg"].family == "encoder"
    got = [h["loss"] for h in res["history"]]
    jcfg = jconfigs.get_smoke("hubert_xlarge").replace(param_dtype="float32")
    jp = jax.tree.map(jnp.asarray, captured["params"])
    jo = jopt.OptConfig(lr=3e-4, warmup_steps=1, total_steps=3)
    jshape = JShape("cli", "train", seq_len=32, global_batch=2)
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
    assert "hubert_xlarge_smoke" in out and "# done:" in out


# ============================================================ checkpoints

def leaf_bits(tree):
    """[(dtype, shape, bytes)] of every leaf in ``jax.tree`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_bits(tree[k])]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        return [(str(t.dtype).removeprefix("torch."), tuple(t.shape),
                 t.reshape(-1).view(torch.uint8).numpy().tobytes())]
    a = np.asarray(tree)
    return [(str(a.dtype), a.shape, a.tobytes())]


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_checkpoint_crosses_packages(arch, writer, tmp_path):
    """One package's train block saves after 2 steps, the other's restores
    it leaf for leaf and bit for bit (the frame tree has no ``embed``),
    and both take 2 more steps with the same losses, grad norms and
    learning rates."""
    jcfg, cfg = cfgs(arch)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    shape = dict(seq_len=16, global_batch=2)
    jjob = JJob(jcfg, JShape("t", "train", **shape), kind="train",
                opt=jopt.OptConfig(**kw), seed=2, ckpt_namespace="blk")
    job = JobSpec(cfg, ShapeConfig("t", "train", **shape), kind="train",
                  opt=opt.OptConfig(**kw), seed=2, ckpt_namespace="blk")
    root = str(tmp_path)
    new = (lambda: JRuntime(JGrant.new([(0, 0, 0)], (1, 1), 60.0), jjob,
                            [jax.devices()[0]], root),
           lambda: BlockRuntime(BlockGrant.new([(0, 0, 0)], (1, 1), 60.0),
                                job, devices=["cpu"], ckpt_root=root))
    first, second = new if writer == "reference" else new[::-1]
    a = first()
    a.init_state()
    a.step(), a.step()
    a.save(async_=False)
    b = second()
    assert b.restore() == 2
    jrt, rt = (a, b) if writer == "reference" else (b, a)
    assert leaf_bits(rt.state) == leaf_bits(np_tree(jrt.state))
    assert ("embed" in rt.state["params"]) == (cfg.frontend != "frame")
    for _ in range(2):
        want, got = jrt.step(), rt.step()
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


# =============================================================== roofline

@pytest.mark.parametrize("kind,seq,batch", [("train", 1024, 8),
                                            ("prefill", 2048, 4)])
@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_and_its_frame_frontend_departure(arch, kind, seq, batch):
    """The Monitor's model FLOPs: pixtral's are the reference's; for the
    frame frontend the reference takes ``vocab_size * d_model`` off as an
    embedding gather it does not have, and the port does not."""
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    want = jhlo.model_step_flops(jcfg, JShape("s", kind, seq, batch))
    got = hlo_analysis.model_step_flops(cfg, ShapeConfig("s", kind, seq,
                                                         batch))
    if cfg.frontend == "frame":
        per_token = 6.0 if kind == "train" else 2.0
        assert got == want + per_token * cfg.vocab_size * cfg.d_model \
            * batch * seq
    else:
        assert got == want


# ============================================== chip_smoke's new phases

def test_chip_smoke_vlm_and_encoder_phases_rehearse_on_cpu():
    """``chip_smoke.py``'s ``serve_vlm`` and ``train_encoder`` at smoke
    size on the CPU: every step eager, no kernel launched, the decode
    positions after the patches, step 0 against ``impl="torch"``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    vlm = smoke.phase_serve_vlm(device="cpu", smoke=True)
    assert vlm["decode_graph"]["eager_calls"] == vlm["gen"] - 1
    pos = vlm["positions"]
    assert pos["cache_len"] == vlm["prompt_len"] + vlm["gen"] - 1
    assert pos["n_patches"] + pos["text_tokens"] == vlm["prompt_len"]
    assert vlm["logits_check"]["passed"]
    assert vlm["captured_vs_eager"]["tokens_equal"]
    enc = smoke.phase_train_encoder(device="cpu", smoke=True)
    chk = enc["step0_check"]
    assert chk["f32"]["within_rtol"] and chk["bf16_vs_f32"]["within_rtol"]
    assert enc["steps"] == 2
    assert set(enc["launches"].values()) == {0}
    assert all(np.isfinite(enc["losses"]))
