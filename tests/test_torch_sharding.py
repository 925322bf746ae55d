"""The port's sharding plans against the reference's, in process.

The reference's plans take a ``jax.sharding`` mesh; at 16 x 16 and
2 x 16 x 16 an ``AbstractMesh`` (its shape arithmetic) stands in for the
devices.  The port's take a ``torch.distributed`` DeviceMesh: the large
ones are built over a fake process group (``FakeStore``), destroyed after
each use so no later test in the worker sees a process group.  Specs are
compared leaf for leaf, the reference's ``PartitionSpec`` read as the
tuple of its entries.
"""
import contextlib

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

import repro.configs as JC  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import serve_step as jserve  # noqa: E402
from repro.sharding import plans as jplans  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jtrain  # noqa: E402
import repro_torch.configs as C  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.models.transformer import flatten  # noqa: E402
from repro_torch.serve import serve_step  # noqa: E402
from repro_torch.sharding import plans  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as train  # noqa: E402

torch.set_num_threads(1)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def device_mesh(name):
    """The port's DeviceMesh of ``MESHES[name]`` over a fake process
    group, destroyed on the way out."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, names = MESHES[name]
    n = int(np.prod(shape))
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(shape),
                         mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def jmesh(name):
    shape, names = MESHES[name]
    return jax.sharding.AbstractMesh(shape, names)


def ref_tuples(tree):
    """The reference's spec tree as {path: tuple} (``{"q","s"}`` dicts
    walked as dicts)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(s) for path, s in leaves}


def _is_spec(t):
    """A spec: a tuple of None, axis names and tuples of axis names (a
    container of specs, the xlstm cache's, holds tuples with None)."""
    return isinstance(t, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(x, str) for x in e))
        for e in t)


def port_tuples(tree, prefix=""):
    """The port's spec tree as {path: tuple}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and not _is_spec(tree):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(port_tuples(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


@pytest.mark.parametrize("arch", C.ARCH_IDS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_specs_equal_the_references(arch, mesh):
    """Every full-size param leaf's spec, leaf for leaf, on (1, 1), (2, 2),
    16 x 16 and 2 x 16 x 16 (the production meshes); and on the
    production mesh the large matrices are sharded."""
    want = ref_tuples(jplans.param_specs(
        jmodel.abstract_params(JC.get(arch)), jmesh(mesh)))
    params = model.abstract_params(C.get(arch))
    with device_mesh(mesh) as dm:
        got = port_tuples(plans.param_specs(params, dm))
    assert got == want
    assert len(got) == len(flatten(params))
    if mesh == "16x16":
        big = [p for p, leaf in flatten(params) if leaf.numel() >= 1 << 24]
        assert big and all(any(e is not None for e in got[p]) for p in big)


@given(dims=st.tuples(st.integers(1, 512), st.integers(1, 512)))
@settings(max_examples=50, deadline=None)
def test_roles_to_spec_property(dims):
    """A dim is sharded only when its axis size divides it, and the port
    resolves roles as the reference does."""
    sizes = {"data": 4, "model": 2}
    axes = plans.MeshAxes(dp=("data",), model="model")
    spec = plans._roles_to_spec(("fsdp", "model"), dims, axes, sizes)
    for entry, d in zip(spec, dims):
        if entry is not None:
            assert d % sizes[entry] == 0
    ref = jplans._roles_to_spec(
        ("fsdp", "model"), dims, jplans.MeshAxes(dp=("data",),
                                                 model="model"),
        jax.sharding.AbstractMesh((4, 2), ("data", "model")))
    assert spec == tuple(ref)
    assert plans._roles_to_spec(("model", "fsdp"), dims, axes, sizes,
                                no_tp=True)[0] is None


@pytest.mark.parametrize("mesh", ["1x1", "2x2", "16x16"])
def test_opt_state_specs_quantized_structure(mesh):
    """int8 moments: q takes the param's spec, s replicates its block dim;
    leaf for leaf the reference's."""
    jcfg = JC.get_smoke("deepseek_7b")
    jstate = jtrain.abstract_train_state(jcfg,
                                         jopt.OptConfig(state_bits=8))
    jp = jplans.param_specs(jstate["params"], jmesh(mesh))
    want = ref_tuples(jplans.opt_state_specs(jstate["opt"], jp))
    state = train.abstract_train_state(C.get_smoke("deepseek_7b"),
                                       opt.OptConfig(state_bits=8))
    with device_mesh(mesh) as dm:
        pspec = plans.param_specs(state["params"], dm)
        ospec = plans.opt_state_specs(state["opt"], pspec)
    got = port_tuples(ospec)
    assert got == want
    qs = [p for p in got if p.endswith("/q")]
    assert qs
    for p in qs:
        s = got[p[:-1] + "s"]
        assert s[:-1] == got[p][:-1] and s[-1] is None


@pytest.mark.parametrize("arch", ["deepseek_7b", "hubert_xlarge",
                                  "pixtral_12b"])
@pytest.mark.parametrize("mesh,batch", [("2x2", 8), ("16x16", 32),
                                        ("16x16", 8)])
def test_batch_specs_equal_the_references(arch, mesh, batch):
    shapes = pipeline.batch_shapes(C.get(arch),
                                   ShapeConfig("t", "train", 512, batch))
    jbatch = {k: jax.ShapeDtypeStruct(s, jnp.float32)
              for k, (s, _) in shapes.items()}
    want = ref_tuples(jplans.batch_specs(jbatch, jmesh(mesh)))
    with device_mesh(mesh) as dm:
        got = port_tuples(plans.batch_specs(
            {k: torch.empty(s, device="meta") for k, (s, _) in
             shapes.items()}, dm))
    assert got == want


@pytest.mark.parametrize("arch", ["deepseek_7b", "zamba2_2p7b",
                                  "deepseek_v2_236b", "xlstm_350m",
                                  "llama4_maverick_400b"])
@pytest.mark.parametrize("mesh,batch", [("2x2", 4), ("16x16", 1),
                                        ("16x16", 32)])
def test_cache_specs_equal_the_references(arch, mesh, batch):
    """KV and recurrent caches (the xlstm's tuples too): batch over dp
    where it divides, else the sequence, channels over model."""
    jcfg, cfg = JC.get_smoke(arch), C.get_smoke(arch)
    want = ref_tuples(jplans.cache_specs(
        jserve.abstract_cache(jcfg, batch, 64), jcfg, jmesh(mesh),
        batch_size=batch))
    with device_mesh(mesh) as dm:
        got = port_tuples(plans.cache_specs(
            serve_step.abstract_cache(cfg, batch, 64), cfg, dm,
            batch_size=batch))
    assert got == want


def test_to_placements():
    sizes = {"pod": 2, "data": 4, "model": 2}
    assert plans.to_placements((None, ("pod", "data"), "model"), sizes) == (
        Shard(1), Shard(1), Shard(2))
    assert plans.to_placements((), sizes) == (Replicate(),) * 3
    assert plans.to_placements(("model", None), {"data": 2, "model": 2}) \
        == (Replicate(), Shard(0))
    assert plans.local_shape((8, 6), (("pod", "data"), None), sizes) == (
        1, 6)
    with device_mesh("2x2") as dm:
        lay = plans.Layout(dm, plans.to_placements(("data", "model"), dm))
        assert lay.local_shape((8, 6)) == (4, 3)
        assert lay.index((8, 6)) == (slice(0, 4), slice(0, 3))


def test_int8_moments_hold_whole_blocks_on_every_rank():
    """deepseek_7b's w_up (30, 4096, 11008): 11008 is 43 blocks, so at
    model = 2 a half of the last dim (21.5 blocks) would cut one; its
    update and moments shard the stack dim instead.  Where the shard
    holds whole blocks (lm_head's 102400 / 2) the plan's spec stays, and
    the scales follow q's last dim."""
    sizes = {"data": 1, "model": 2}
    w_up = plans.param_specs({"w_up": torch.empty(30, 4096, 11008,
                                                  device="meta")},
                             sizes)["w_up"]
    assert w_up == (None, "data", "model")
    assert plans.update_spec(w_up, (30, 4096, 11008), sizes) == (
        "model", "data", None)
    head = ("data", "model")
    assert plans.update_spec(head, (4096, 102400), sizes) == head
    assert plans.scale_spec(head, (4096, 102400), sizes) == head
    assert plans.scale_spec(("data", "model"), (8, 768), sizes) == (
        "data", None)
    # 4 x 2: 11008 / 2 still cuts a block; 4096 / 4 stays on dim 1
    assert plans.update_spec(w_up, (30, 4096, 11008),
                             {"data": 4, "model": 2}) == (
        "model", "data", None)
    assert plans.update_spec(("data",), (64,), {"data": 2, "model": 1}) \
        == (None,)


def test_mesh_module_touches_no_process_group():
    import importlib
    from repro_torch.launch import mesh as mesh_lib
    importlib.reload(mesh_lib)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_block_mesh([0, 1], (1, 2))
