"""The reference configs that ``chip_smoke.py`` runs last on the card, on
the CPU: llama4_maverick_400b on both packages' paged planes at the
default capacity factor, where a round's idle slots and an admission's
page padding take capacity and choices are dropped (every session's
greedy tokens the reference ``DecodeScheduler``'s); a one-group model's
params drawn as the stacked init draws them; the launches the card is
held to at these configs' full sizes; and the four phases
(``serve_llama4``, ``serve_llama4_paged``, ``serve_dense_groups``,
``train_vlm``) at smoke size, where every kernel's plain version runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve.decode_scheduler import DecodeScheduler as JScheduler  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import model, moe  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.transformer import flatten  # noqa: E402
from repro_torch.serve.decode_scheduler import DecodeScheduler  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402

torch.set_num_threads(1)   # several test workers share the host's cores

LLAMA4 = "llama4_maverick_400b"


def _load_chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def drain(sch, cap=500):
    ems = []
    for _ in range(cap):
        if not sch.has_work:
            return ems
        ems.extend(sch.step(now=0.0))
    raise AssertionError("scheduler did not drain")


# ============================================ llama4 on the paged planes

def test_llama4_paged_plane_at_capacity_factor_1p25_vs_reference():
    """llama4's smoke config in fp32 on both packages' schedulers at the
    default capacity factor 1.25: 5 sessions of 5 to 13 prompt tokens
    through 3 slots, 6 tokens each, a page of 4.  Rounds with an idle
    slot (the last sessions') and admissions padded to a page multiple
    route those rows too, and at C = max(1, ceil(T / 8 * 1.25)) choices
    are dropped, in the rounds and in the admissions (counted in the
    port's run).  The emission streams are the reference's, so every
    session's greedy tokens are."""
    jcfg = jconfigs.get_smoke(LLAMA4).replace(param_dtype="float32")
    cfg = configs.get_smoke(LLAMA4).replace(param_dtype="float32")
    assert cfg.moe.capacity_factor == jcfg.moe.capacity_factor == 1.25
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(21))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    geom = dict(page_size=4, n_pages=0, max_slots=3, max_seq_len=40)
    js = JScheduler(jcfg, jp, **geom)
    ts = DecodeScheduler(cfg, tp, device="cpu", **geom)
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 9, 13, 7, 11)]
    sids = []
    for p in prompts:
        sids.append(js.submit(p, max_new_tokens=6))
        assert ts.submit(p, max_new_tokens=6) == sids[-1]

    route, drops = moe.route, {"round": 0, "admission": 0}

    def tap(xs, router, mcfg):
        r = route(xs, router, mcfg)
        kind = "round" if xs.shape[0] == geom["max_slots"] else "admission"
        drops[kind] += int((r[2] == mcfg.n_experts * r[4]).sum())
        return r

    moe.route = tap
    try:
        got = drain(ts)
    finally:
        moe.route = route
    assert drops["round"] > 0 and drops["admission"] > 0, drops
    assert got == drain(js)
    for sid in sids:
        assert ts.sessions[sid].generated == js.sessions[sid].generated
        assert len(ts.sessions[sid].generated) == 6


# ======================================================= the init repair

def _half_last_dim(path, leaf):
    """A stand-in for a rank's ``place``: the first half of a leaf's last
    dim, the leaf itself where that dim is odd or the leaf is a vector."""
    if leaf.dim() < 2 or leaf.shape[-1] % 2:
        return leaf
    return leaf[..., :leaf.shape[-1] // 2]


@pytest.mark.parametrize("place", [None, _half_last_dim],
                         ids=["whole", "placed"])
def test_one_group_init_is_the_stacked_init(place):
    """A one-group model's layers are its group's leaves with a stack dim
    of 1, not copied into a preallocated stack (llama4's one-group cut at
    full width: 33 GB a copy): the same draws, so the same numbers as the
    first group of a two-group model from the same seed, whole and with a
    ``place`` that slices (its copy then keeps no view of the whole
    leaf)."""
    cfg = configs.get_smoke(LLAMA4)
    one = model.init_params(cfg.replace(n_layers=2), seed=3, device="cpu",
                            place=place)
    two = model.init_params(cfg, seed=3, device="cpu")
    a, b = dict(flatten(one["layers"])), dict(flatten(two["layers"]))
    assert set(a) == set(b)
    for path, leaf in a.items():
        want = b[path][0]
        if place is not None:
            want = place("layers/" + path, want)
            assert leaf.untyped_storage().nbytes() == leaf.nbytes, path
        assert leaf.shape[0] == 1 and leaf.is_contiguous()
        assert torch.equal(leaf[0], want), path


# ============================================== launches at full sizes

def test_launch_counts_the_card_is_held_to():
    """The kernels' launches ``chip_smoke.py`` holds each new phase to, at
    full size: llama4's one-group cut a prefill 2 flash and 5 RMSNorms, a
    decode step 5, a paged round 2 paged decodes and 5; starcoder2_15b
    (LayerNorm, plain PyTorch) 40 flash and no RMSNorm, 40 paged decodes
    a round; yi_34b 60 flash and 121 RMSNorms; pixtral_12b's 20-layer
    train step 40 / 20 flash, 81 / 41 RMSNorms, an int8 AdamW a leaf."""
    smoke = _load_chip_smoke()
    _, l4 = smoke._llama4(False)
    assert l4.n_layers == smoke.LLAMA4_LAYERS == 2
    pre, dec, rnd = smoke.dense_launches(l4)
    assert (pre["flash_attention"], pre["rmsnorm"]) == (2, 5)
    assert dec["rmsnorm"] == 5 and dec["flash_attention"] == 0
    assert (rnd["paged_attention"], rnd["rmsnorm"]) == (2, 5)
    for arch, flash, norms in (("starcoder2_15b", 40, 0),
                               ("yi_34b", 60, 121)):
        pre, dec, rnd = smoke.dense_launches(configs.get(arch))
        assert (pre["flash_attention"], pre["rmsnorm"]) == (flash, norms)
        assert dec["rmsnorm"] == norms
        assert rnd["paged_attention"] == flash
    cfg = configs.get("pixtral_12b").replace(
        n_layers=smoke.VLM_TRAIN_LAYERS)
    params = model.abstract_params(cfg)
    want = smoke.train_launches(
        cfg, ShapeConfig("t", "train", 2048, 2, microbatch=1),
        OptConfig(state_bits=8), params)
    assert (want["flash_attention"], want["flash_attention_bwd"]) == (40, 20)
    assert (want["rmsnorm"], want["rmsnorm_bwd"]) == (81, 41)
    assert want["fused_adamw_i8"] == len(flatten(params))
    assert want["fused_adamw_scalar"] == 0
    assert {smoke._gqa(configs.get(a))["paged_gc"] for a in (
        LLAMA4, "starcoder2_15b", "yi_34b")} == {5, 6, 7}


# ================================================ chip_smoke's phases

def test_chip_smoke_serve_llama4_rehearses_on_cpu():
    """``serve_llama4`` at smoke size: every decode step eager, no kernel
    launched, the logits against ``impl="torch"`` with the plain run's
    routing replayed, the captured-against-eager tokens equal, the drop
    shares in [0, 1]."""
    out = _load_chip_smoke().phase_serve_llama4(device="cpu", smoke=True)
    assert out["arch"] == "llama4_maverick_400b_smoke"
    assert out["decode_graph"]["eager_calls"] == out["gen"] - 1
    assert out["logits_check"]["passed"]
    assert out["logits_check"]["routing"] == "the plain run's, replayed"
    assert out["captured_vs_eager"]["tokens_equal"]
    assert set(out["launches"].values()) == {0}
    for k in ("prefill", "decode"):
        assert 0.0 <= out["capacity_drop"][k]["dropped_share"] <= 1.0
    assert out["top_k"] == 1 and out["group"] == 2


def test_chip_smoke_serve_llama4_paged_rehearses_on_cpu():
    """``serve_llama4_paged`` at smoke size: 12 sessions through 8 slots
    over the {dense, moe} pool, the admission and first-round logits with
    the routing replayed, the eager replay's tokens and pool bit for bit,
    the drops of live and idle slots, prompts and padding in [0, 1]."""
    out = _load_chip_smoke().phase_serve_llama4_paged(device="cpu",
                                                      smoke=True)
    assert out["decode_rounds"] > 0 and out["sessions"] == 12
    assert out["logits_check"]["passed"]
    assert all(c["passed"] for c in out["admission_logits_checks"])
    cve = out["captured_vs_eager"]
    assert cve["tokens_equal"] and cve["pool_bitwise_equal"]
    assert set(out["launches"].values()) == {0}
    drop = out["capacity_drop"]
    assert set(drop) == {"decode_live", "decode_idle", "admission_prompt",
                         "admission_pad"}
    for v in drop.values():
        assert v["choices"] > 0 and 0.0 <= v["dropped_share"] <= 1.0


def test_chip_smoke_serve_dense_groups_rehearses_on_cpu():
    """``serve_dense_groups`` at smoke size: starcoder2_15b and yi_34b on
    both planes, logits checked, replays equal to eager."""
    out = _load_chip_smoke().phase_serve_dense_groups(device="cpu",
                                                      smoke=True)
    assert set(out) == {"starcoder2_15b", "yi_34b"}
    assert out["starcoder2_15b"]["norm"] == "layer"
    assert not out["starcoder2_15b"]["mlp_gated"]
    for run in out.values():
        d, p = run["dense"], run["paged"]
        assert d["logits_check"]["passed"] and p["logits_check"]["passed"]
        assert d["captured_vs_eager"]["tokens_equal"]
        assert p["captured_vs_eager"]["tokens_equal"]
        assert p["captured_vs_eager"]["pool_bitwise_equal"]
        assert set(d["launches"].values()) == set(
            p["launches"].values()) == {0}


def test_chip_smoke_train_vlm_rehearses_on_cpu():
    """``train_vlm`` at smoke size: step 0 in fp32 within its limits and
    the bf16 one held against it, 2 steps with finite losses, the first
    step's loss the step-0 check's bf16 one, no kernel launched."""
    out = _load_chip_smoke().phase_train_vlm(device="cpu", smoke=True)
    chk = out["step0_check"]
    assert chk["f32"]["within_rtol"] and chk["bf16_vs_f32"]["within_rtol"]
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))
    assert out["step0_loss_equals_check"]
    assert out["n_patches"] > 0
    assert out["group"] == out["n_heads"] // out["n_kv_heads"]
    assert set(out["launches"].values()) == {0}
