"""The port's sharding rules, production meshes and cell specs against the
JAX package's, on the CPU.

Every registry cell's input specs on the production meshes (16, 16) and (2,
16, 16), at full size and reduced, equal the reference cell's ``in_specs``
path for path, as tuples, and the per-device argument bytes they imply equal
the reference's (each abstract argument's bytes over the product of the mesh
axes its spec names): exactly, both being integer arithmetic. The rules
themselves (``logical_spec``, ``param_spec``, ``zero1_spec``) equal the
reference's on assorted names and shapes under abstract meshes, with no
mesh, and on the (1, 1) host mesh. Without a mesh every leaf counts whole.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.distributed import sharding as jshard
from repro_torch.configs.registry import all_cells
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.launch.steps import cell_specs
from tests._reference_cells import MESHES, as_spec, reference_cells
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

CELLS = all_cells()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_cells(str(tmp_path_factory.mktemp("reference_cells")))


def _mesh(name: str) -> Mesh:
    return make_production_mesh(multi_pod=name == "2x16x16")


def test_the_registry_has_the_references_40_cells():
    from repro.configs.registry import all_cells as j_all_cells

    assert CELLS == j_all_cells() and len(CELLS) == 40


def test_production_and_host_meshes():
    one, two, host = make_production_mesh(), make_production_mesh(multi_pod=True), \
        make_host_mesh()
    assert one.shape == {"data": 16, "model": 16} and one.n_devices == 256
    assert two.shape == {"pod": 2, "data": 16, "model": 16} and two.n_devices == 512
    assert host.shape == {"data": 1, "model": 1} and host.n_devices == 1
    for name, (shape, axes) in MESHES.items():
        assert _mesh(name) == Mesh(axes, shape)
    with pytest.raises(ValueError):
        Mesh(("data",), (2, 2))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_specs_equal_the_reference_in_specs(arch, shape, mesh_name, reduced, ref):
    specs, nbytes = cell_specs(arch, shape, _mesh(mesh_name), reduced=reduced)
    key = f"{mesh_name}|{int(reduced)}|{arch}|{shape}"
    want = {path: as_spec(spec) for path, spec in ref["specs"][key].items()}
    assert specs == want
    assert nbytes == ref["bytes"][key]


def test_cell_specs_without_a_mesh_replicate_and_count_whole_leaves():
    from repro_torch.launch.steps import _lm_inputs
    from repro_torch.configs.registry import get_arch

    specs, nbytes = cell_specs("qwen2-1.5b", "long_500k", None)
    assert specs and all(s == () for s in specs.values())
    inputs = _lm_inputs("qwen2-1.5b", get_arch("qwen2-1.5b").shapes["long_500k"], False, None)
    whole = sum(int(np.prod(shp)) * dt.itemsize for tree, _ in inputs[:2]
                for shp, dt in tree.values()) + 4 + 4
    assert nbytes == whole == 18_586_561_544
    # DLRM's tables (the reference's float32: 91.1 GB, and as much again of
    # master copy) are arithmetic only
    from repro_torch.configs import dlrm_mlperf

    cfg = dlrm_mlperf.config()
    tables = 4 * cfg.embed_dim * sum(cfg.padded_rows(r) for r in cfg.row_counts)
    _, nbytes = cell_specs("dlrm-mlperf", "train_batch", None)
    assert 2 * tables < nbytes < 2 * tables + 10**9


_NAMES = [
    (("batch", None), (256, 4096)), (("batch", None), (2, 64)), (("batch",), (1,)),
    ((None, None, "batch", "kv_seq", "kv_heads", None), (28, 1, 1, 524288, 2, 128)),
    ((None, "batch", "kv_seq", "kv_heads", None), (16, 128, 32768, 16, 128)),
    (("edges",), (61859328,)), (("edges", None), (168960, 8)), (("edges",), (100,)),
    (("table_rows", None), (1000192, 128)), (("wide_batch", None), (65536, 13)),
    (("wide_batch", None), (512, 13)), (("vocab", None), (151936, 1536)),
    (("heads", "kv_heads"), (32, 16)), (("experts", None, None), (16, 2048, 1024)),
    (("seq_model", "model_dim", "fields", "expert_cap"), (4096, 8, 3, 64)),
    (("unknown", None), (4, 4)), ((), ()),
]
_PATHS = [
    ("embed", (151936, 1536)), ("layers/wq", (28, 1536, 1536)), ("layers/wk", (28, 1536, 256)),
    ("layers/wo", (21, 2, 4096, 3584)), ("layers/w_gate", (28, 1536, 8960)),
    ("layers/w_down", (28, 8960, 1536)), ("layers/w_up_e", (16, 64, 2048, 1024)),
    ("layers/router", (16, 2048, 64)), ("w_vocab", (1536, 151936)), ("ln_final", (1536,)),
    ("tables/table_0", (40000000, 128)), ("tables/table_3", (768, 128)),
    ("bot/0/w", (13, 512)), ("top/4/b", (1,)), ("layers/0/w", (1433, 16)),
    ("blocks/0/edge_mlp/0/w", (384, 128)), ("layers/0/rad0/0/w", (8, 32)),
    ("layers/bq", (28, 1536)), ("layers/w_qkv", (3,)),
]
_ABSTRACT = [(name, AbstractMesh(shape, axes)) for name, (shape, axes) in MESHES.items()]
_ABSTRACT.append(("1x1", AbstractMesh((1, 1), ("data", "model"))))


def _port_mesh(name):
    return make_host_mesh() if name == "1x1" else _mesh(name)


@pytest.mark.parametrize("mesh_name,amesh", _ABSTRACT, ids=[n for n, _ in _ABSTRACT])
def test_the_rules_equal_the_references(mesh_name, amesh, ref):
    # `ref` runs first: its child gives this module's jax no mesh of its own
    mesh = _port_mesh(mesh_name)
    try:
        ctx = jax.sharding.use_abstract_mesh(amesh)
        ctx.__enter__()
    except ValueError:
        pytest.fail("another module set a global jax mesh of another size in this process")
    try:
        for names, shape in _NAMES:
            assert sharding.logical_spec(names, shape, mesh) == tuple(
                jshard.logical_spec(names, shape)), (names, shape)
            assert sharding.logical_spec(names, None, mesh) == tuple(
                jshard.logical_spec(names, None)), names
        for path, shape in _PATHS:
            spec = sharding.param_spec(path, shape, mesh)
            assert spec == tuple(jshard.param_spec(path, shape)), path
            assert sharding.zero1_spec(spec, shape, mesh) == tuple(
                jshard.zero1_spec(P(*spec), shape)), path
    finally:
        ctx.__exit__(None, None, None)


def test_no_mesh_gives_empty_specs():
    assert sharding.logical_spec(("batch", None), (256, 4)) == ()
    assert sharding.param_spec("embed", (10, 4)) == ()
    assert sharding.zero1_spec((None, "model"), (16, 16)) == (None, "model")
    assert sharding.zero1_spec(("data",), (16,), make_production_mesh()) == ("data",)
    assert sharding.zero1_spec((None,), (3,), Mesh(("model",), (4,))) == (None,)


def test_shard_returns_its_input():
    x = torch.ones(4, 3)
    assert sharding.shard(x, ("batch", None)) is x
    assert sharding.shard(x, ("batch", None), make_production_mesh()) is x
    assert sharding.shard(x, ("batch",)) is x  # no mesh: nothing to check, as the reference
    with pytest.raises(ValueError, match="rank"):
        sharding.shard(x, ("batch",), make_production_mesh())


@pytest.mark.parametrize("shape,itemsize,spec,want", [
    ((256, 64), 4, ("data", None), 256 * 64 * 4 // 16),
    ((256, 64), 2, (("data", "model"), None), 256 * 64 * 2 // 256),
    ((512, 8), 4, (("pod", "data"), "model"), 512 * 8 * 4 // 512),
    ((), 4, (), 4),
    ((7, 3), 1, (None, None), 21),
])
def test_spec_bytes(shape, itemsize, spec, want):
    mesh = make_production_mesh(multi_pod="pod" in str(spec))
    assert sharding.spec_bytes(shape, itemsize, spec, mesh) == want
