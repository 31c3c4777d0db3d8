"""The port stands alone: it imports neither jax nor the JAX package, its
entry points refuse to run on a missing GPU unless asked for the CPU, and
``chip_smoke.py`` fails without a GPU or without the port beside it."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"


def _run(code, cwd=ROOT):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
        "assert not bad, bad\n"
        "print('OK', len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
    )
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("OK")


def test_port_sources_name_no_reference_import():
    offenders = []
    paths = [*sorted((SRC / "repro_torch").rglob("*.py")), ROOT / "chip_smoke.py"]
    core, persist = SRC / "repro_torch" / "core", SRC / "repro_torch" / "persist"
    data = SRC / "repro_torch" / "data"
    serve, dist = SRC / "repro_torch" / "serve", SRC / "repro_torch" / "distributed"
    assert {core / "delta.py", core / "result_cache.py", core / "query.py",
            core / "itr_plus.py", persist / "crash.py", persist / "snapshot.py",
            core / "bgp.py", core / "term_dict.py", data / "rdf.py", data / "ingest.py",
            data / "graph_store.py", serve / "concurrency.py", serve / "triple_service.py",
            serve / "sharded.py", dist / "__init__.py", dist / "partition.py",
            dist / "rebalance.py", persist / "wal.py", persist / "service.py",
            serve / "replication.py", SRC / "repro_torch" / "launch" / "itr_durable.py",
            SRC / "repro_torch" / "baselines" / "__init__.py",
            SRC / "repro_torch" / "baselines" / "k2_triples.py",
            SRC / "repro_torch" / "baselines" / "hdt_bt.py",
            SRC / "repro_torch" / "baselines" / "ntriples.py", core / "ablations.py",
            data / "sampler.py", SRC / "repro_torch" / "train" / "checkpoint.py",
            SRC / "repro_torch" / "train" / "compression.py",
            SRC / "repro_torch" / "train" / "fault_tolerance.py",
            SRC / "repro_torch" / "configs" / "gatedgcn.py",
            SRC / "repro_torch" / "launch" / "gnn_compressed.py",
            SRC / "repro_torch" / "launch" / "train.py",
            SRC / "repro_torch" / "roofline" / "__init__.py",
            SRC / "repro_torch" / "roofline" / "analysis.py",
            SRC / "repro_torch" / "roofline" / "op_cost.py",
            dist / "collectives.py", dist / "sharding.py",
            SRC / "repro_torch" / "launch" / "mesh.py",
            SRC / "repro_torch" / "launch" / "dryrun.py"} <= set(paths)
    for path in paths:
        for line in path.read_text().splitlines():
            words = line.strip().split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 and (
                    words[1].split(".")[0] in ("jax", "jaxlib", "repro")):
                offenders.append(f"{path}: {line.strip()}")
    assert offenders == []


def _without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-GPU refusal cannot be observed")


def _zero_dlrm_params(cfg):
    f = cfg.n_fields
    sizes = {"bot": [cfg.n_dense, *cfg.bot_mlp],
             "top": [f * (f - 1) // 2 + cfg.embed_dim, *cfg.top_mlp]}
    return {"tables": {f"table_{i}": np.zeros((cfg.padded_rows(r), cfg.embed_dim), np.float32)
                       for i, r in enumerate(cfg.row_counts)},
            **{k: [{"w": np.zeros((a, b), np.float32), "b": np.zeros(b, np.float32)}
                   for a, b in zip(s[:-1], s[1:])] for k, s in sizes.items()}}


def _zero_lm_params(cfg):
    from repro_torch.models.transformer import param_shapes

    flat = {k: np.zeros(shape, np.float32) for k, (shape, _) in param_shapes(cfg).items()}
    top = ("embed", "ln_final", "w_vocab")
    return {**{k: flat[k] for k in top},
            "layers": {k: v for k, v in flat.items() if k not in top}}


@pytest.mark.parametrize("entry", ["resolve_device", "from_triples", "terminals",
                                   "from_numpy_state", "bitvector", "dlrm_from_config",
                                   "dlrm_from_numpy_params", "build_cell",
                                   "transformer_from_config", "transformer_from_numpy_params",
                                   "lm_build_cell", "gcn_from_config",
                                   "gcn_from_numpy_params", "gnn_build_cell",
                                   "dlrm_train_build_cell", "load_snapshot",
                                   "graph_store_from_triples", "parse_ntriples",
                                   "sharded_build", "durable_build", "durable_open",
                                   "k2_triples", "hdt_bt", "gatedgcn_from_config",
                                   "restore_checkpoint", "gnn_compressed_main",
                                   "meshgraphnet_from_config", "nequip_from_config",
                                   "lm_train_build_cell", "lm_train_main", "dryrun_main",
                                   "dryrun_run_cell", "partitioned_segment_sum"])
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(entry, tmp_path):
    _without_cuda()
    from repro_torch import resolve_device
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.configs.dlrm_mlperf import reduced
    from repro_torch.core import Hypergraph, LabelTable, TripleQueryEngine
    from repro_torch.core.succinct import BitVector
    from repro_torch.launch.steps import build_cell
    from repro_torch.configs import gcn_cora
    from repro_torch.models.dlrm import DLRM
    from repro_torch.models.gnn import GCN
    from repro_torch.models.transformer import Transformer
    from repro_torch.data import GraphStore, parse_ntriples
    from repro_torch.persist import load_snapshot
    from repro_torch.persist import DurableShardedService
    from repro_torch.serve import ShardedTripleService
    from repro_torch.baselines import HDTBitmapTriples, K2Triples
    from repro_torch.configs import gatedgcn
    from repro_torch.launch import gnn_compressed
    from repro_torch.models.gnn import GatedGCN, MeshGraphNet, NequIP
    from repro_torch.configs import meshgraphnet, nequip
    from repro_torch.train import restore_checkpoint, save_checkpoint
    from repro_torch.launch import train as lm_train
    from repro_torch.launch import dryrun
    from repro_torch.distributed import partitioned_segment_sum

    save_checkpoint(str(tmp_path / "ckpt"), 1, {"w": np.zeros(2, np.float32)})

    triples = np.array([[0, 0, 1], [1, 0, 2]])
    calls = {
        "resolve_device": lambda dev: resolve_device(dev),
        "from_triples": lambda dev: Hypergraph.from_triples(triples, 3, device=dev),
        "terminals": lambda dev: LabelTable.terminals([2], device=dev),
        "from_numpy_state": lambda dev: TripleQueryEngine.from_numpy_state({}, {}, device=dev),
        "bitvector": lambda dev: BitVector(np.array([1, 0, 1]), device=dev),
        "dlrm_from_config": lambda dev: DLRM.from_config(reduced(), device=dev),
        "dlrm_from_numpy_params": lambda dev: DLRM.from_numpy_params(
            _zero_dlrm_params(reduced()), reduced(), device=dev),
        "build_cell": lambda dev: build_cell("dlrm-mlperf", "serve_p99", reduced=True,
                                             device=dev),
        "transformer_from_config": lambda dev: Transformer.from_config(
            qwen2_1_5b.reduced(), device=dev),
        "transformer_from_numpy_params": lambda dev: Transformer.from_numpy_params(
            _zero_lm_params(qwen2_1_5b.reduced()), qwen2_1_5b.reduced(), device=dev),
        "lm_build_cell": lambda dev: build_cell("qwen2-1.5b", "decode_32k", reduced=True,
                                                device=dev),
        "gcn_from_config": lambda dev: GCN.from_config(gcn_cora.reduced(), 16, 7, device=dev),
        "gcn_from_numpy_params": lambda dev: GCN.from_numpy_params(
            {"layers": [{"w": np.zeros((16, 8), np.float32), "b": np.zeros(8, np.float32)},
                        {"w": np.zeros((8, 7), np.float32), "b": np.zeros(7, np.float32)}]},
            gcn_cora.reduced(), device=dev),
        "gnn_build_cell": lambda dev: build_cell("gcn-cora", "full_graph_sm", reduced=True,
                                                 device=dev),
        "dlrm_train_build_cell": lambda dev: build_cell("dlrm-mlperf", "train_batch",
                                                        reduced=True, device=dev),
        "load_snapshot": lambda dev: load_snapshot(ROOT / "no-such-snapshot", device=dev),
        "graph_store_from_triples": lambda dev: GraphStore.from_triples(
            torch.from_numpy(triples), 3, 1, device=dev),
        "parse_ntriples": lambda dev: parse_ntriples(ROOT / "tests" / "fixtures" / "small.nt",
                                                     device=dev),
        "sharded_build": lambda dev: ShardedTripleService.build(triples, 3, 1, n_shards=2,
                                                                device=dev),
        "durable_build": lambda dev: DurableShardedService.build(
            triples, 3, 1, root=tmp_path / "svc", n_shards=2, fsync=False, device=dev).close(),
        "durable_open": lambda dev: DurableShardedService.open(ROOT / "no-such-service",
                                                               device=dev),
        "k2_triples": lambda dev: K2Triples(triples, 3, 1, device=dev),
        "hdt_bt": lambda dev: HDTBitmapTriples(triples, 3, 1, device=dev),
        "gatedgcn_from_config": lambda dev: GatedGCN.from_config(gatedgcn.reduced(), 8, 4, 3,
                                                                 device=dev),
        "restore_checkpoint": lambda dev: restore_checkpoint(str(tmp_path / "ckpt"),
                                                             device=dev),
        "meshgraphnet_from_config": lambda dev: MeshGraphNet.from_config(
            meshgraphnet.reduced(), 16, 8, 3, device=dev),
        "nequip_from_config": lambda dev: NequIP.from_config(nequip.reduced(), 64, device=dev),
        "lm_train_build_cell": lambda dev: build_cell("gemma2-9b", "train_4k", reduced=True,
                                                      device=dev),
        "lm_train_main": lambda dev: lm_train.main(
            ["--arch", "qwen2-1.5b", "--reduced", "--steps", "1"]
            + ([] if dev is None else ["--device", dev])),
        "dryrun_main": lambda dev: dryrun.main(
            ["--arch", "gcn-cora", "--shape", "molecule", "--reduced"]
            + ([] if dev is None else ["--device", dev])),
        "dryrun_run_cell": lambda dev: dryrun.run_cell("gcn-cora", "molecule", reduced=True,
                                                       device=dev),
        "partitioned_segment_sum": lambda dev: partitioned_segment_sum(
            torch.ones((4, 2), device=resolve_device(dev)), torch.tensor([0, 1, 1, 0]), 2),
        "gnn_compressed_main": lambda dev: gnn_compressed.main(
            dev, n_nodes=60, n_edges=200, seeds=8, fanouts=(3, 2), total_steps=2,
            checkpoint_every=1, log_every=1, fail_at=1, out=lambda *_: None),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry](None)
    if entry not in ("from_numpy_state", "load_snapshot", "durable_open"):  # need real input
        calls[entry]("cpu")  # asking for the CPU works
    if entry == "durable_build":  # and the directory it wrote opens on the CPU
        DurableShardedService.open(tmp_path / "svc", device="cpu").close()
        with pytest.raises(RuntimeError, match="CUDA"):
            DurableShardedService.open(tmp_path / "svc")


def test_cell_specs_need_no_device():
    # the specs are host arithmetic: they run with no GPU and name none
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import cell_specs

    specs, nbytes = cell_specs("dlrm-mlperf", "train_batch", make_production_mesh())
    assert specs and nbytes > 0


def test_chip_smoke_fails_without_cuda():
    _without_cuda()
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
