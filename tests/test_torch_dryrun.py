"""The port's dry run and roofline tooling (item 10) against the JAX
package's, on the CPU.

* ``launch/hlo_parse.py`` and ``launch/attribute.py`` are verbatim copies
  (``tests/test_torch_package.py``); here the twins of the reference's
  tests of them (``tests/test_plans_and_hlo.py``): the while loops' trip
  counts, and the parser against XLA's cost analysis on a scan-free
  program, plus ``attribute`` on the same text as the reference's.
* ``configs.cell_status``/``all_cells``, ``data.pipeline.input_specs``
  and ``hlo_analysis.collective_stats`` equal the reference's.
* ``Roofline`` on the H100's peaks; ``dryrun_roofline`` reads only the
  port's sweep directory; ``block_roofline`` prefers a port cell's
  counted FLOPs and keeps its floor compute-bound.
* A kernel's call on fake tensors is counted by its bound formula,
  allocates only its outputs and is never launched nor replaced by its
  plain version; a real CPU tensor still takes the plain version.
* A subprocess runs the dry run's CLI (a ``fake`` process group) on one
  train, one prefill and one decode cell of deepseek_7b's smoke config
  on a ``(2, 2, 1)`` ``("pod", "data", "model")`` mesh; 4 real gloo
  ranks run the same train step under the same ``StepCounter``.  The
  fake run's collective bytes and counts by kind, and its bytes across
  pods, equal rank 0's real ones; its state bytes equal rank 0's local
  shards' sum.  The same gloo ranks count the pod traffic of item 9's
  two train steps against ``hlo_analysis.pod_traffic``'s computed
  operand bytes.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.launch import attribute as jattribute  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import hlo_parse as jhlo_parse  # noqa: E402
import repro_torch.configs as C  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import attribute, hlo_analysis, hlo_parse  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
           JAX_PLATFORMS="cpu")

torch.set_num_threads(1)

# the reference's test program (``tests/test_plans_and_hlo.py``): a
# while loop of 7 trips around a dot and an all-reduce
SAMPLE = """
HloModule test, num_partitions=4

%cond (arg: (s32[], f32[8,8])) -> pred[] {
  %arg = (s32[], f32[8,8]) parameter(0)
  %i = s32[] get-tuple-element(%arg), index=0
  %n = s32[] constant(7)
  ROOT %lt = pred[] compare(%i, %n), direction=LT
}

%body (arg: (s32[], f32[8,8])) -> (s32[], f32[8,8]) {
  %arg = (s32[], f32[8,8]) parameter(0)
  %i = s32[] get-tuple-element(%arg), index=0
  %one = s32[] constant(1)
  %i2 = s32[] add(%i, %one)
  %x = f32[8,8]{1,0} get-tuple-element(%arg), index=1
  %d = f32[8,8]{1,0} dot(%x, %x), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %ar = f32[8,8]{1,0} all-reduce(%d), replica_groups={}, to_apply=%cond
  ROOT %t = (s32[], f32[8,8]) tuple(%i2, %ar)
}

ENTRY %main (p0: f32[8,8]) -> f32[8,8] {
  %p0 = f32[8,8]{1,0} parameter(0)
  %c0 = s32[] constant(0)
  %t0 = (s32[], f32[8,8]) tuple(%c0, %p0)
  %w = (s32[], f32[8,8]) while(%t0), condition=%cond, body=%body
  ROOT %out = f32[8,8]{1,0} get-tuple-element(%w), index=1
}
"""

# collectives of every kind the parser knows, in one text
COLLECTIVES = """
  %ag = bf16[16,4096]{1,0} all-gather(bf16[1,4096]{1,0} %a), dimensions={0}
  %ags = (bf16[2,8]{1,0}, bf16[4,8]{1,0}) all-gather-start(bf16[2,8]{1,0} %b)
  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %c), to_apply=%add
  %ars = f32[8]{0} all-reduce-start(f32[8]{0} %d), to_apply=%add
  %rs = f32[64]{0} reduce-scatter(f32[1024]{0} %e), dimensions={0}
  %a2a = s8[4,4]{1,0} all-to-all(s8[4,4]{1,0} %f), dimensions={0}
  %cp = u32[3]{0} collective-permute(u32[3]{0} %g), source_target_pairs={{0,1}}
  %cb = pred[5]{0} collective-broadcast(pred[5]{0} %h)
  ROOT %x = f32[8] add(%i, %j)
"""


def test_hlo_while_trip_expansion():
    costs = hlo_parse.analyze_text(SAMPLE)
    assert costs.flops == pytest.approx(7 * 1024, rel=0.01)
    assert costs.coll_bytes["all-reduce"] == pytest.approx(7 * 256)
    assert costs.coll_counts["all-reduce"] == 7


def test_hlo_backend_config_trip():
    txt = SAMPLE.replace(
        "while(%t0), condition=%cond, body=%body",
        'while(%t0), condition=%cond, body=%body, '
        'backend_config={"known_trip_count":{"n":"3"}}')
    costs = hlo_parse.analyze_text(txt)
    assert costs.flops == pytest.approx(3 * 1024, rel=0.01)


def test_hlo_parser_matches_xla_on_scanfree_program():
    """The port's copy against XLA's cost analysis, and against the
    reference's parser, on the same compiled text."""
    def f(a, b):
        return jnp.tanh(a @ b)
    a = jnp.ones((64, 128), jnp.float32)
    b = jnp.ones((128, 32), jnp.float32)
    compiled = jax.jit(f).lower(a, b).compile()
    text = compiled.as_text()
    ours = hlo_parse.analyze_text(text)
    cost = compiled.cost_analysis()
    if isinstance(cost, list):
        cost = cost[0]
    want = float(cost.get("flops", 0))
    assert abs(ours.flops - want) / want < 0.1
    ref = jhlo_parse.analyze_text(text)
    assert (ours.flops, ours.hbm_bytes) == (ref.flops, ref.hbm_bytes)


def test_attribute_equals_the_reference():
    got = attribute.attribute(SAMPLE, depth=3)
    want = jattribute.attribute(SAMPLE, depth=3)
    assert [dict(c) for c in got] == [dict(c) for c in want]
    assert sum(got[0].values()) == pytest.approx(7 * 1024, rel=0.01)


@pytest.mark.parametrize("text", [SAMPLE, COLLECTIVES],
                         ids=["while", "every_kind"])
def test_collective_stats_equal_the_reference(text):
    got = hlo_analysis.collective_stats(text)
    want = jhlo.collective_stats(text)
    assert got.counts == want.counts and got.counts
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.total_bytes == want.total_bytes
    assert got.total_count == want.total_count


def test_model_step_flops_and_block_roofline(monkeypatch, tmp_path):
    """The twin of the reference's analytic roofline test, on the H100's
    peak: 6ND train / 2ND inference and a floor that scales down with
    the chips; no sweep for a smoke config gives None."""
    monkeypatch.setattr(hlo_analysis, "DRYRUN_DIR", str(tmp_path))
    cfg = C.get_smoke("deepseek_7b")
    train = ShapeConfig("t", "train", seq_len=32, global_batch=4,
                        microbatch=2)
    decode = ShapeConfig("d", "decode", seq_len=32, global_batch=4)
    ft = hlo_analysis.model_step_flops(cfg, train)
    fd = hlo_analysis.model_step_flops(cfg, decode)
    assert ft > 0 and fd > 0
    assert ft == pytest.approx(3 * train.seq_len * fd)
    r4 = hlo_analysis.block_roofline(cfg, train, 4)
    r8 = hlo_analysis.block_roofline(cfg, train, 8)
    assert r4["model_flops"] == ft and r4["n_chips"] == 4
    assert r4["source"] == "analytic" and r4["bottleneck"] == "compute"
    assert r4["step_time_s"] == pytest.approx(2 * r8["step_time_s"])
    assert r4["step_time_s"] == pytest.approx(
        ft / (4 * hlo_analysis.PEAK_FLOPS))
    assert hlo_analysis.dryrun_roofline(cfg.name, "no_such_shape") is None


def test_roofline_on_the_h100_peaks():
    assert hlo_analysis.PEAK_FLOPS == 989e12
    assert hlo_analysis.HBM_BW == 3.35e12
    assert hlo_analysis.LINK_BW == 450e9 and hlo_analysis.POD_LINK_BW == 50e9
    counts = {"flops": 2e12, "bytes": 1e10,
              "coll_bytes": {"all-reduce": 3e9, "all-gather": 1e9},
              "coll_counts": {"all-reduce": 2, "all-gather": 1},
              "pod_bytes": 1e9, "peak_bytes": 5e9}
    r = hlo_analysis.analyze(counts, n_chips=4, model_flops=6e12)
    assert r.compute_s == pytest.approx(2e12 / 989e12)
    assert r.memory_s == pytest.approx(1e10 / 3.35e12)
    assert r.collective_s == pytest.approx(3e9 / 450e9 + 1e9 / 50e9)
    assert r.bottleneck == "collective"
    d = r.to_dict()
    ref_keys = set(jhlo.Roofline(1.0, 1.0, 1.0, 1).to_dict())
    assert ref_keys <= set(d) and d["xla_cost"] is None
    assert d["coll_detail"]["counts"] == counts["coll_counts"]
    assert d["bytes_per_device"] == 5e9 and d["n_chips"] == 4
    assert d["roofline_fraction"] == pytest.approx(
        6e12 / (r.step_time_s * 4 * 989e12))


def test_dryrun_roofline_reads_only_the_ports_directory(monkeypatch,
                                                        tmp_path):
    """The default directory is the port's own; a line in a directory
    named as the reference's is never read, one in the port's is, and a
    single-pod line wins over a multi-pod one."""
    assert os.path.normpath(hlo_analysis.DRYRUN_DIR).endswith(
        os.path.join("artifacts", "dryrun_torch"))
    port, ref = tmp_path / "dryrun_torch", tmp_path / "dryrun"
    port.mkdir()
    ref.mkdir()
    monkeypatch.setattr(hlo_analysis, "DRYRUN_DIR", str(port))
    line = {"arch": "deepseek_7b", "shape": "train_4k", "status": "ok",
            "mesh": "multi", "roofline": {"step_time_s": 1.5,
                                          "bottleneck": "memory",
                                          "model_flops": 7.0,
                                          "hlo_flops": 0.0}}
    (ref / "sweep.jsonl").write_text(json.dumps(line) + "\n")
    assert hlo_analysis.dryrun_roofline("deepseek_7b", "train_4k") is None
    cfg = C.get("deepseek_7b")
    shape = C.shape("train_4k")
    assert hlo_analysis.block_roofline(cfg, shape, 256)["source"] \
        == "analytic"
    (port / "a.jsonl").write_text(json.dumps(line) + "\n" + "not json\n")
    single = dict(line, mesh="single",
                  roofline=dict(line["roofline"], step_time_s=0.5))
    (port / "b.jsonl").write_text(json.dumps(single) + "\n")
    got = hlo_analysis.dryrun_roofline("deepseek_7b", "train_4k")
    assert got["step_time_s"] == 0.5
    r = hlo_analysis.block_roofline(cfg, shape, 256)
    assert r["source"] == "dryrun" and r["model_flops"] == 7.0
    assert r["dryrun"] == {"step_time_s": 0.5, "bottleneck": "memory"}


def test_block_roofline_floor_is_compute_bound(monkeypatch, tmp_path):
    """With a port cell, the floor is the larger of the analytic one and
    the cell's counted FLOPs over the block's chips at the peak, never
    the cell's eager memory term (on an H100 the train step ran under
    it); the cell's roofline rides beside under ``dryrun``."""
    monkeypatch.setattr(hlo_analysis, "DRYRUN_DIR", str(tmp_path))
    cfg, shape = C.get("deepseek_7b"), C.shape("train_4k")
    analytic = hlo_analysis.block_roofline(cfg, shape, 4)
    assert "dryrun" not in analytic
    flops = hlo_analysis.model_step_flops(cfg, shape)
    cell = hlo_analysis.analyze(
        {"flops": 1.25 * flops / 256, "bytes": 1e13}, n_chips=256,
        model_flops=flops).to_dict()
    assert cell["bottleneck"] == "memory"
    (tmp_path / "c.jsonl").write_text(json.dumps(
        {"arch": cfg.name, "shape": shape.name, "status": "ok",
         "mesh": "single", "roofline": cell}) + "\n")
    for chips in (4, 256):
        r = hlo_analysis.block_roofline(cfg, shape, chips)
        assert r["source"] == "dryrun" and r["bottleneck"] == "compute"
        assert r["step_time_s"] == pytest.approx(
            1.25 * flops / (chips * hlo_analysis.PEAK_FLOPS))
        assert r["dryrun"]["memory_s"] == cell["memory_s"]
        assert r["dryrun"]["n_chips"] == 256
    assert r["step_time_s"] == pytest.approx(cell["compute_s"])
    assert r["step_time_s"] < r["dryrun"]["step_time_s"]
    # a cell that counted fewer FLOPs than the model's keeps the analytic
    low = dict(cell, hlo_flops=0.5 * flops)
    (tmp_path / "c.jsonl").write_text(json.dumps(
        {"arch": cfg.name, "shape": shape.name, "status": "ok",
         "mesh": "single", "roofline": low}) + "\n")
    assert hlo_analysis.block_roofline(cfg, shape, 4)["step_time_s"] == \
        analytic["step_time_s"]


def test_cell_table_equals_the_reference():
    got = list(C.all_cells())
    assert got == list(JC.all_cells())
    assert len(got) == 40
    runs = [c for c in got if c[2] == "run"]
    assert len(runs) == 31
    for a, s, st in got:
        assert C.cell_status(a, s) == JC.cell_status(a, s) == st


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_input_specs_cover_cells(arch):
    """The twin of the reference's test: a stand-in for every input of
    every executed train and prefill cell, on ``meta``, of the
    reference's ``ShapeDtypeStruct`` shape and dtype."""
    dtypes = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
              jnp.bool_: torch.bool}
    cfg, jcfg = C.get(arch), JC.get(arch)
    for shape_name in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        status = C.cell_status(arch, shape_name)
        if status != "run":
            assert "skip" in status
            continue
        shape = C.shape(shape_name)
        if shape.kind not in ("train", "prefill"):
            continue
        specs = pipeline.input_specs(cfg, shape)
        want = jpipeline.input_specs(jcfg, JC.shape(shape_name))
        assert specs and set(specs) == set(want)
        for k, v in specs.items():
            assert v.device.type == "meta"
            assert v.shape[0] == shape.global_batch
            assert tuple(v.shape) == tuple(want[k].shape)
            assert v.dtype == dtypes[want[k].dtype.type]


# ------------------------------------------------ kernels on fake tensors

def test_kernels_on_fake_tensors_are_counted_not_run(monkeypatch):
    """Under ``FakeTensorMode`` each kernel wrapper adds its bound
    formula to ``FAKE_COST`` and allocates its outputs; the plain
    versions (and the kernels) are never called."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_adamw as fo
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.train import quantized_state as qs

    def boom(*a, **k):
        raise AssertionError("a kernel or its plain version ran")
    for mod, names in ((fa, ("flash_attention_torch", "flash_attention_cuda",
                             "flash_attention_bwd_torch",
                             "flash_attention_bwd_cuda")),
                       (rn, ("rmsnorm_torch", "rmsnorm_cuda")),
                       (ssd, ("ssd_scan_torch", "ssd_scan_cuda")),
                       (fo, ("fused_adamw_torch", "fused_adamw_cuda"))):
        for n in names:
            monkeypatch.setattr(mod, n, boom)
    ops.reset_fake_cost()
    B, H, S, D = 2, 4, 64, 32
    with FakeTensorMode():
        q = torch.empty(B, H, S, D, dtype=torch.bfloat16, requires_grad=True)
        k = torch.empty(B, H, S, D, dtype=torch.bfloat16, requires_grad=True)
        v = torch.empty(B, H, S, D, dtype=torch.bfloat16, requires_grad=True)
        o = ops.flash_attention(q, k, v)
        assert o.shape == (B, H, S, D)
        o.sum().backward()
        assert q.grad.shape == q.shape
        x = torch.empty(8, 128, dtype=torch.bfloat16, requires_grad=True)
        s = torch.empty(128, dtype=torch.bfloat16, requires_grad=True)
        ops.rmsnorm(x, s).sum().backward()
        xs = torch.empty(1, 300, 2, 16, dtype=torch.bfloat16)
        y, h = ops.ssd_scan(xs, torch.empty(1, 300, 2), torch.empty(2),
                            torch.empty(1, 300, 8, dtype=torch.bfloat16),
                            torch.empty(1, 300, 8, dtype=torch.bfloat16),
                            torch.empty(2), chunk=128)
        assert y.shape == xs.shape and h.shape == (1, 2, 16, 8)
        p = torch.empty(4, 512, dtype=torch.bfloat16)
        m = qs.zeros_like_quantized(p)
        ops.fused_adamw(p, torch.empty_like(p), m, m, lr=1e-3, scale=1.0,
                        bc1=0.1, bc2=0.1, b1=0.9, b2=0.95, eps=1e-8,
                        weight_decay=0.1)
    calls = ops.FAKE_COST["calls"]
    assert calls == {"flash_attention": 1, "flash_attention_bwd": 1,
                     "rmsnorm": 1, "rmsnorm_bwd": 1, "ssd_scan": 1,
                     "fused_adamw": 1}
    pairs = ops.attention_pairs(B, H, S, S, causal=True)
    assert pairs == B * H * S * (S + 1) // 2
    flash = pairs * 2 * (D + D) + pairs * 2 * (3 * D + 2 * D)
    chunks = 128 * 129 * (8 + 16) + 4 * 128 * 8 * 16
    ssd_f = 2 * (2 * chunks + 44 * 45 * (8 + 16) + 4 * 44 * 8 * 16)
    assert ops.FAKE_COST["flops"] == (flash + 4 * 8 * 128 + 10 * 8 * 128
                                      + ssd_f + 20 * 4 * 512)
    # the flash forward's bytes: q, k, v read, o and the fp32 lse written
    qkv = 2 * B * H * S * D
    assert ops.FAKE_COST["bytes"] > 4 * qkv + 4 * B * H * S
    # a real CPU tensor takes the plain version as before
    monkeypatch.undo()
    ops.reset_fake_cost()
    x = torch.randn(4, 64)
    torch.testing.assert_close(ops.rmsnorm(x, torch.ones(64)),
                               rn.rmsnorm_torch(x, torch.ones(64)))
    assert ops.FAKE_COST["calls"] == {}


def test_slstm_on_fake_tensors_is_counted_not_run(monkeypatch):
    """The sLSTM block on fake tensors, forward and backward, from the
    initial state and from a given one: ``ops.slstm_scan`` goes through
    ``_FakeSLSTMScan``, which charges the forward 2 S B H Dh 4 Dh FLOPs
    and the backward twice that (dg R^T in the kernel, dR after it) and
    never runs the plain loop or a kernel; outputs and cotangents have
    their real shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import slstm as sl
    from repro_torch.models import ssm

    def boom(*a, **k):
        raise AssertionError("the sLSTM loop or a kernel ran")
    for n in ("slstm_scan_torch", "slstm_scan_cuda", "slstm_scan_bwd_cuda",
              "slstm_scan_bwd_torch"):
        monkeypatch.setattr(sl, n, boom)
    cfg = C.get_smoke("xlstm_350m").xlstm
    d, B, S = 64, 2, 24
    H, Dh = cfg.n_heads, d // cfg.n_heads
    ops.reset_fake_cost()
    with FakeTensorMode():
        p = ssm.slstm_init(torch.Generator().manual_seed(0), d, cfg,
                           torch.float32, "cpu")
        p = {k: v.requires_grad_() for k, v in p.items()}
        x = torch.empty(B, S, d, requires_grad=True)
        out, st = ssm.slstm_fwd(p, x, cfg, d)
        assert out.shape == (B, S, d)
        assert all(t.shape == (B, H, Dh) for t in st["slstm"])
        out.sum().backward()
        assert x.grad.shape == x.shape
        assert p["r_gates"].grad.shape == (H, Dh, 4 * Dh)
        state = {"slstm": tuple(torch.empty(B, H, Dh) for _ in range(4))}
        ssm.slstm_fwd({k: v.detach() for k, v in p.items()},
                      torch.empty(B, 1, d), cfg, d, state=state)
    calls = ops.FAKE_COST["calls"]
    assert calls == {"slstm_scan": 2, "slstm_scan_bwd": 1, "rmsnorm": 2,
                     "rmsnorm_bwd": 1}
    f = 2 * S * B * H * Dh * 4 * Dh
    assert ops.slstm_flops(B, S, H, Dh) == f
    norms = 4 * B * S * d + 10 * B * S * d + 4 * B * d
    assert ops.FAKE_COST["flops"] == f + 2 * f + f // S + norms


def test_mlstm_on_fake_tensors_is_counted_not_run(monkeypatch):
    """The mLSTM block on fake tensors, forward and backward from no
    state, then a prefill from a given state: ``ops.mlstm_scan`` goes
    through ``_FakeMLSTMScan``, which charges the forward
    ``ops.mlstm_flops`` (the causal pairs of q k^T and of the weighted
    scores by v, Q (Q + 1) (Dk + Dv), and the carry's two products, 4 Q
    Dk Dv, over the chunks) and the backward twice that, the saved
    carries and rows in the forward's bytes when a gradient is needed,
    and never runs the plain loop or a kernel; outputs and cotangents
    have their real shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import mlstm as ml
    from repro_torch.models import ssm

    def boom(*a, **k):
        raise AssertionError("the mLSTM loop or a kernel ran")
    for n in ("mlstm_scan_torch", "mlstm_scan_cuda", "mlstm_scan_bwd_cuda",
              "mlstm_scan_bwd_torch", "mlstm_saved_torch"):
        monkeypatch.setattr(ml, n, boom)
    cfg = C.get_smoke("xlstm_350m").xlstm
    d, B, S = 64, 2, 24
    inner, Dk, Dv, H = ssm._mlstm_dims(d, cfg)
    Q, nc = cfg.chunk, -(-S // cfg.chunk)
    ops.reset_fake_cost()
    with FakeTensorMode():
        p = ssm.mlstm_init(torch.Generator().manual_seed(0), d, cfg,
                           torch.float32, "cpu")
        p = {k: v.requires_grad_() for k, v in p.items()}
        x = torch.empty(B, S, d, requires_grad=True)
        out, st = ssm.mlstm_fwd(p, x, cfg, d)
        assert out.shape == (B, S, d)
        assert [tuple(t.shape) for t in st["mlstm"]] == [
            (B, H, Dk, Dv), (B, H, Dk), (B, H)]
        out.sum().backward()
        assert x.grad.shape == x.shape
        assert p["wq"].grad.shape == p["wq"].shape
        state = ssm.mlstm_state_spec(cfg, d, B, torch.float32)
        state = {"conv": torch.empty(state["conv"][0]),
                 "mlstm": tuple(torch.empty(s) for s, _ in state["mlstm"])}
        ssm.mlstm_fwd({k: v.detach() for k, v in p.items()},
                      torch.empty(B, S, d), cfg, d, state=state)
    calls = ops.FAKE_COST["calls"]
    assert calls == {"mlstm_scan": 2, "mlstm_scan_bwd": 1, "rmsnorm": 2,
                     "rmsnorm_bwd": 1}
    f = nc * B * H * (Q * (Q + 1) * (Dk + Dv) + 4 * Q * Dk * Dv)
    assert ops.mlstm_flops(B, H, S, Dk, Dv, Q) == f
    norms = 4 * B * S * inner + 10 * B * S * inner + 4 * B * S * inner
    assert ops.FAKE_COST["flops"] == f + 2 * f + f + norms
    # the forward with a gradient wrote the saved carries and rows
    saved = 4 * (nc * B * H * (Dk * Dv + Dk + 1) + 3 * B * H * nc * Q
                 + B * H * nc * Q * Dv)
    assert ops.FAKE_COST["bytes"] > saved + 2 * 4 * B * S * inner


DRY_XLSTM = r"""
import sys
from repro_torch.launch import dryrun
rc = 0
for kind in ("train", "prefill"):
    rc |= dryrun.main(["--arch", "xlstm_350m", "--smoke", "--kind", kind,
                       "--shape", f"smoke_{kind}", "--seq-len", "16",
                       "--global-batch", "2", "--mesh-shape", "1,1",
                       "--out", sys.argv[1]])
print("DRY_RC", rc)
"""


def test_dryrun_xlstm_counts_the_slstm_kernels(tmp_path):
    """An xlstm dry run (the smoke config, a (1, 1) fake mesh) counts the
    sLSTM and mLSTM kernels as the card launches them (a train step: 2
    forward a layer with remat's recompute, 1 backward, as
    ``chip_smoke.train_launches``; a prefill: 1) and their FLOPs in the
    step's: never the sLSTM loop's S steps of small products nor the
    mLSTM loop's chunks."""
    out = tmp_path / "x.jsonl"
    r = subprocess.run([sys.executable, "-c", DRY_XLSTM, str(out)],
                       env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "DRY_RC 0" in r.stdout, r.stderr[-4000:]
    lines = {d["entry"]: d for d in map(json.loads,
                                        out.read_text().splitlines())}
    cfg = C.get_smoke("xlstm_350m")
    n_slstm = cfg.n_layers // cfg.xlstm.slstm_every
    H, Dh = cfg.xlstm.n_heads, cfg.d_model // cfg.xlstm.n_heads
    f = ops.slstm_flops(2, 16, H, Dh)
    train, pre = lines["train_step"], lines["prefill_step"]
    assert train["status"] == pre["status"] == "ok"
    assert train["kernels"]["slstm_scan"] == 2 * n_slstm
    assert train["kernels"]["slstm_scan_bwd"] == n_slstm
    assert pre["kernels"]["slstm_scan"] == n_slstm
    assert "slstm_scan_bwd" not in pre["kernels"]
    assert train["roofline"]["hlo_flops"] > 4 * n_slstm * f
    assert pre["roofline"]["hlo_flops"] > n_slstm * f
    n_mlstm = cfg.n_layers - n_slstm
    xc = cfg.xlstm
    inner = int(xc.proj_factor * cfg.d_model)
    fm = ops.mlstm_flops(2, xc.n_heads, 16, int(xc.qk_factor * inner)
                         // xc.n_heads, inner // xc.n_heads, xc.chunk)
    assert train["kernels"]["mlstm_scan"] == 2 * n_mlstm
    assert train["kernels"]["mlstm_scan_bwd"] == n_mlstm
    assert pre["kernels"]["mlstm_scan"] == n_mlstm
    assert "mlstm_scan_bwd" not in pre["kernels"]
    assert train["roofline"]["hlo_flops"] > 4 * (n_slstm * f + n_mlstm * fm)
    assert pre["roofline"]["hlo_flops"] > n_slstm * f + n_mlstm * fm


# --------------------------------------------------- the fake-group runs

DRY = r'''
import json, sys
from repro_torch.launch import dryrun
out = sys.argv[1]
rc = 0
for kind, extra in (("train", ["--microbatch", "2", "--global-batch", "8"]),
                    ("prefill", ["--global-batch", "4"]),
                    ("decode", ["--global-batch", "4"])):
    rc |= dryrun.main(["--arch", "deepseek_7b", "--smoke", "--kind", kind,
                       "--shape", f"smoke_{kind}", "--seq-len", "16",
                       "--mesh", "multi", "--mesh-shape", "2,2,1",
                       "--out", f"{out}/sweep.jsonl"] + extra)
print("DRY_RC", rc)
'''

RANKS = r'''
import json, sys
import torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from repro_torch import device as D
D.init_distributed("cpu", store=dist.FileStore(store, world), rank=rank,
                   world_size=world, timeout_s=120)
import dataclasses
import repro_torch.configs as C
from repro_torch.data import pipeline
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_block_mesh
from repro_torch.models import model as model_lib
from repro_torch.models.config import ShapeConfig
from repro_torch.sharding import ctx as shard_ctx, plans
from repro_torch.train import optimizer as opt_lib, train_step as T

cfg = C.get_smoke("deepseek_7b")
shape = ShapeConfig("smoke_train", "train", 16, 8, 2)
mesh = make_block_mesh(range(4), (2, 2, 1), ("pod", "data", "model"))
res = {}
# the dry run's own layout: MeshAxes.from_mesh, the batch over (pod, data)
axes = plans.MeshAxes.from_mesh(mesh)
opt = opt_lib.OptConfig()
lay = plans.state_layouts(model_lib.abstract_params(cfg), mesh, axes)
state = T.make_sharded_train_state(cfg, 0, opt, lay, device="cpu")
shards = pipeline.batch_shards(mesh, axes.dp, 2)
ctx = shard_ctx.ShardCtx(mesh, axes.dp, "model",
                         shards_batch=shards.split(8),
                         tp=plans.tp_layout(cfg, mesh))
data = pipeline.DataIterator(cfg, shape, device="cpu", shardings=shards)
step = T.make_train_step(cfg, shape, opt)
res["state_bytes"] = dryrun.state_bytes(state)
c = dryrun.StepCounter(ranks_per_pod=2)
b = data.batch(0)
with c, shard_ctx.use(ctx):
    step(state, b)
res["dry_layout"] = c.counts()
# item 9's steps: the params replicated over pod
f32 = dataclasses.replace(cfg, param_dtype="float32")
axes = plans.MeshAxes(dp=("data",), model="model")
lay = plans.state_layouts(model_lib.abstract_params(f32), mesh, axes)
ctx = shard_ctx.ShardCtx(mesh, ("pod", "data"), "model",
                         tp=plans.tp_layout(f32, mesh))
data = pipeline.DataIterator(f32, shape, device="cpu", shardings=shards)
for name, kw in (("serial", {}),
                 ("overlap", dict(overlap_comm=True, mesh=mesh))):
    state = T.make_sharded_train_state(f32, 0, opt, lay, device="cpu")
    step = T.make_train_step(f32, shape, opt, **kw)
    c = dryrun.StepCounter(ranks_per_pod=2)
    with c, shard_ctx.use(ctx):
        step(state, data.batch(0))
    res[name] = c.counts()
print("RESULT " + json.dumps(res))
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dry run's subprocess and the 4 gloo ranks, side by side."""
    tmp = tmp_path_factory.mktemp("dry")
    dry = subprocess.Popen([sys.executable, "-c", DRY, str(tmp)], env=ENV,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    ranks = [subprocess.Popen(
        [sys.executable, str(script), str(r), "4", str(tmp / "store")],
        env=ENV, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    outs = []
    try:
        for p in [dry] + ranks:
            outs.append(p.communicate(timeout=240))
    finally:
        for p in [dry] + ranks:
            p.kill()
    for p, (so, se) in zip([dry] + ranks, outs):
        assert p.returncode == 0, f"failed:\n{so[-2000:]}\n{se[-4000:]}"
    assert "DRY_RC 0" in outs[0][0], outs[0][0][-2000:]
    lines = [json.loads(x) for x in
             (tmp / "sweep.jsonl").read_text().splitlines()]
    res = [json.loads([x for x in so.splitlines()
                       if x.startswith("RESULT ")][-1][len("RESULT "):])
           for so, _ in outs[1:]]
    return {"lines": {d["entry"]: d for d in lines}, "ranks": res,
            "dir": tmp}


def test_dryrun_cells_reach_ok(runs):
    lines = runs["lines"]
    assert set(lines) == {"train_step", "prefill_step", "decode_step"}
    for d in lines.values():
        assert d["status"] == "ok" and d["n_chips"] == 4
        assert d["mesh_layout"] == "2x2x1(pod,data,model)"
        mem = d["memory"]
        assert 0 < mem["state_bytes"] <= mem["peak_bytes_per_device"]
        assert mem["fits"] and mem["device_bytes"] == 80e9
        roof = d["roofline"]
        assert roof["hlo_flops"] > 0 and roof["hlo_bytes"] > 0
        assert roof["pod_collective_bytes"] > 0
        assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert lines["train_step"]["kernels"]["flash_attention_bwd"] > 0
    assert lines["train_step"]["kernels"]["fused_adamw"] > 0
    assert lines["prefill_step"]["kernels"]["flash_attention"] > 0
    assert "flash_attention" not in lines["decode_step"]["kernels"]
    assert lines["decode_step"]["kernels"]["decode_attention"] > 0


def test_dryrun_collectives_equal_real_gloo_ranks(runs):
    """The fake group's train step issues, collective by collective, the
    bytes and counts rank 0 of 4 real gloo ranks issues."""
    d = runs["lines"]["train_step"]
    real = runs["ranks"][0]["dry_layout"]
    roof = d["roofline"]
    assert roof["coll_detail"]["bytes_by_kind"] == real["coll_bytes"]
    assert roof["coll_detail"]["counts"] == real["coll_counts"]
    assert roof["pod_collective_bytes"] == 4 * real["pod_bytes"]
    assert roof["collective_bytes"] == 4 * sum(real["coll_bytes"].values())


def test_dryrun_state_bytes_equal_the_local_shards(runs):
    d = runs["lines"]["train_step"]
    assert d["memory"]["state_bytes"] == runs["ranks"][0]["state_bytes"]


def _local_leaves(cfg, mesh):
    """Meta tensors of a rank's shards of ``cfg``'s params, the pod a
    replica axis."""
    from repro_torch.models import model as model_lib
    from repro_torch.sharding import plans
    params = model_lib.abstract_params(cfg)
    spec = dict(plans._dict_leaves(plans.param_specs(
        params, mesh, plans.MeshAxes(dp=("data",), model="model"))))
    return [torch.empty(plans.local_shape(p.shape, spec[k], mesh),
                        device="meta")
            for k, p in plans._dict_leaves(params)]


def test_pod_traffic_is_what_the_ranks_move(runs):
    """``hlo_analysis.pod_traffic``'s computed operand bytes over the
    pods, for item 9's serial and overlapped steps, against what the
    gloo ranks counted: the int8 all-gather's one byte an element (the
    reference's int32 psum would take 4), the serial fp32 path far
    more."""
    import dataclasses
    f32 = dataclasses.replace(C.get_smoke("deepseek_7b"),
                              param_dtype="float32")
    shape = ShapeConfig("smoke_train", "train", 16, 8, 2)
    mesh = {"pod": 2, "data": 2, "model": 1}
    want = hlo_analysis.pod_traffic(f32, shape, mesh)
    for r in runs["ranks"]:
        assert r["serial"]["pod_bytes"] == want["serial"]["operand"]
        assert r["overlap"]["pod_bytes"] == want["overlap"]["operand"]
    # each rank's elements: the deepseek smoke params over the 2 data ranks
    leaves = _local_leaves(f32, mesh)
    local = sum(t.numel() for t in leaves)
    assert want["overlap"]["operand"] == shape.microbatch * (
        local + 4 * len(leaves)) + 4 * shape.microbatch
    assert want["serial"]["operand"] > 7 * want["overlap"]["operand"]


# ------------------------------------- item 8g: zamba2's cells, B = 1

ZAMBA = r'''
import json, sys
from repro_torch.launch import dryrun
from repro_torch.models.config import ShapeConfig
from torch._subclasses.fake_tensor import FakeTensorMode

out = {}
dryrun.fake_world(256)
mesh = dryrun.block_mesh(None, False)
for shape in ("train_4k", "prefill_32k", "decode_32k"):
    # the layout and its gaps only: a train_4k cell's step takes minutes
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell, meta = dryrun.lower_cell("zamba2_2p7b", shape,
                                       multi_pod=False, mesh=mesh)
    out[shape] = {"gaps": cell.gaps, "cache": meta.get("cache")}
out["long_500k"] = dryrun.run_cell("zamba2_2p7b", "long_500k",
                                   multi_pod=False)
# a B = 1 decode of MLA and of the hybrid, at smoke size on (2, 2)
dryrun.fake_world(4)
small = dryrun.block_mesh((2, 2), False)
b1 = ShapeConfig("b1", "decode", seq_len=32, global_batch=1)
import repro_torch.configs as C
for arch in ("deepseek_v2_236b", "zamba2_2p7b"):
    with FakeTensorMode(allow_non_fake_inputs=True):
        cell, meta = dryrun.lower_cell(arch, "b1", multi_pod=False,
                                       cfg=C.get_smoke(arch), shape=b1,
                                       mesh=small)
    out[f"b1_{arch}"] = {"gaps": cell.gaps, "cache": meta["cache"]}
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def zamba_cells():
    r = subprocess.run([sys.executable, "-c", ZAMBA], env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_zamba2_cells_on_16x16_keep_no_hybrid_or_b1_gap(zamba_cells):
    """zamba2_2p7b's four cells on the 16x16 mesh: no ``family: hybrid``
    rule and no B = 1 gap (its Mamba2 heads, shared attention, MLP and
    vocabulary compute sharded over ``model``; long_500k's one row holds
    its cache's positions over ``data``)."""
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        gaps = zamba_cells[shape]["gaps"]
        assert gaps == [], (shape, gaps)
    assert zamba_cells["long_500k"]["status"] == "ok"


def test_long_500k_cache_is_the_reference_specs_but_conv(zamba_cells):
    """long_500k's per-rank ``k``, ``v`` and ``ssm`` bytes are the
    reference's ``cache_specs`` arithmetic: 9 groups x 524288 / 16
    positions x 32 / 16 kv heads x 80 x 2 bytes each of K and V (0.19
    GB together, not 48.3 GB) and 9 x 5 Mamba2 states of 80 / 16 heads
    x 64 x 64 fp32; the ``conv`` state departs by heads, named, its
    bytes a rank's 5120 / 16 x channels and 2 x 64 of B and C."""
    line = zamba_cells["long_500k"]
    cache = line["cache"]
    kv = 9 * (524288 // 16) * (32 // 16) * 80 * 2
    assert cache["bytes"]["k"] == cache["bytes"]["v"] == kv
    assert cache["bytes"]["k"] + cache["bytes"]["v"] == 188_743_680
    assert cache["bytes"]["ssm"] == 9 * 5 * (80 // 16) * 64 * 64 * 4
    for name in ("k", "v", "ssm"):
        assert cache["bytes"][name] == cache["reference_bytes"][name]
    assert cache["bytes"]["conv"] == 9 * 5 * 3 * (5120 // 16 + 128) * 2
    assert cache["reference_bytes"]["conv"] == 9 * 5 * 3 * (5248 // 16) * 2
    assert set(cache["departs"]) == {"conv"}
    assert "contiguous chunks" in cache["departs"]["conv"]
    # the rank's state: the params' shard and this cache
    assert line["memory"]["state_bytes"] < 0.25e9
    for shape in ("prefill_32k", "decode_32k"):
        c = zamba_cells[shape]["cache"]
        assert set(c["departs"]) == {"conv"}, shape


def test_b1_decode_gaps_name_what_is_still_kept(zamba_cells):
    """A B = 1 decode on (2, 2): the hybrid's GQA cache holds its
    positions over ``data`` (no gap); MLA computes its heads over
    ``model`` and holds its compressed cache's positions over ``data``,
    the reference spec's bytes (no gap, no departure)."""
    z = zamba_cells["b1_zamba2_2p7b"]
    assert z["gaps"] == [] and set(z["cache"]["departs"]) == {"conv"}
    v2 = zamba_cells["b1_deepseek_v2_236b"]
    assert v2["gaps"] == []
    assert v2["cache"]["departs"] == {}
    assert v2["cache"]["bytes"] == v2["cache"]["reference_bytes"]
    # 2 layers x 32 / 2 positions x 16 lanes x 2 bytes
    assert v2["cache"]["bytes"]["c_kv"] == 2 * 16 * 16 * 2


# ------------------------------------------------------------ chip_smoke

def test_chip_smoke_overlap_and_dryrun_phases_rehearse_on_cpu():
    """chip_smoke.py's ``train_overlap`` and ``dryrun`` at smoke size on
    the CPU: the serial and overlapped steps on a one-rank gloo group
    (destroyed after), step 0's loss bit for bit and its grad norm
    within the residual's bound, the losses within 0.05, the codec's
    checks; the dry run's subprocess of ``train``'s job reaching ``ok``
    with ``train``'s state bytes exactly."""
    import importlib.util
    from pathlib import Path
    import torch.distributed as dist
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    over = smoke.phase_train_overlap(device="cpu", smoke=True)
    assert not dist.is_initialized()
    for moments in ("int8", "f32"):
        run = over[moments]
        assert run["step0"]["loss_bitwise_equal"]
        assert run["step0"]["within_bound"]
        assert 0 < run["step0"]["residual_bound"]
        assert run["launches_equal_serial"]
    assert over["f32"]["losses_close"]
    for path in ("serial", "overlap"):
        exposed = over["int8"][path]["eps_exposed"]
        assert len(exposed) == over["steps"]
        assert all(0 <= x <= 1 for x in exposed)
        assert "eps_exposed" not in over["f32"][path]
    assert over["ef_bytes"] > 0
    assert all(c["bitwise_equal"] for c in over["codec"].values())
    train = smoke.phase_train(device="cpu", smoke=True)
    dry = smoke.phase_dryrun(train, smoke=True, timeout_s=180)
    assert dry["state_bytes_equal"] and dry["state_bytes"] > 0
    assert dry["entry"] == "train_step"
    assert dry["mesh_layout"] == "1x1(data,model)"
    assert dry["kernels"]["fused_adamw"] > 0
