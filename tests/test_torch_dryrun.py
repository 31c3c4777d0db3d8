"""The port's one-card dry-run (``repro_torch.launch.dryrun``) and the LM
trainer's mesh flags, on the CPU.

``--reduced --device cpu`` runs one cell of each family and kind and writes
the reference's keys where they have a meaning (``mesh``, ``n_devices``,
``memory.argument_bytes``, ``roofline``, ``model_flops_global``,
``collectives``, ``wire_bytes_per_dev``) and the port's (``build_s``,
``step_s``, ``counted_flops``, ``useful_flops_ratio``, ``unseen_launches``,
``useful_flops_rate``, None on the CPU). Refusals, running out of memory
and faults each give their record; the per-device argument bytes are
``cell_specs``'; the roofline is ``roofline_terms`` of the model FLOPs and
the resident bytes (exactly). Importing the dry-run sets no environment
variable, unlike the reference's, which sets ``XLA_FLAGS``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import dryrun, steps
from repro_torch.launch import train as lm_train
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import HW, model_flops, roofline_terms
from tests._torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
KINDS = [("qwen2-1.5b", "train_4k"), ("olmoe-1b-7b", "prefill_32k"),
         ("gemma2-9b", "decode_32k"), ("qwen2-1.5b", "long_500k"),
         ("gcn-cora", "full_graph_sm"), ("nequip", "minibatch_lg"),
         ("gatedgcn", "molecule"), ("meshgraphnet", "full_graph_sm"),
         ("dlrm-mlperf", "train_batch"), ("dlrm-mlperf", "serve_p99"),
         ("dlrm-mlperf", "retrieval_cand")]
RUN_KEYS = {"arch", "shape", "mesh", "n_devices", "ok", "memory", "build_s", "step_s",
            "roofline", "model_flops_global", "useful_flops_rate", "counted_flops",
            "useful_flops_ratio", "unseen_launches", "cost", "launches", "finite",
            "collectives", "wire_bytes_per_dev", "device", "card", "hw", "reduced"}


@pytest.mark.parametrize("arch,shape", KINDS)
def test_a_reduced_cell_on_the_cpu_writes_the_keys(arch, shape, tmp_path):
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", arch, "--shape", shape, "--reduced", "--device", "cpu",
                        "--both-meshes", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["pod16x16", "pod2x16x16"]
    assert [r["n_devices"] for r in recs] == [256, 512]
    for r, mp in zip(recs, (False, True)):
        assert RUN_KEYS <= set(r) and r["ok"] and r["finite"]
        assert r["device"] == "cpu" and r["card"] == "cpu" and r["reduced"]
        assert len(r["step_s"]) == 2 and all(t > 0 for t in r["step_s"]) and r["build_s"] > 0
        assert r["useful_flops_rate"] is None  # a CPU step is no measure of the card
        assert r["unseen_launches"] == {} and r["launches"] == {}  # the plain twins ran
        assert r["collectives"] == {} and r["wire_bytes_per_dev"] == 0.0
        assert r["counted_flops"] > 0 and r["cost"]["bytes"] > 0
        assert r["useful_flops_ratio"] == r["model_flops_global"] / r["counted_flops"]
        meta = dryrun._cell_meta(arch, shape, reduced=True)
        assert r["model_flops_global"] == model_flops(arch, shape, meta)
        mem = r["memory"]
        assert mem["argument_bytes"] == steps.cell_specs(
            arch, shape, make_production_mesh(multi_pod=mp), reduced=True)[1]
        assert mem["resident_bytes"] > 0 and "peak_bytes" not in mem
        assert r["roofline"] == roofline_terms(r["model_flops_global"], mem["resident_bytes"],
                                               0.0, HW())
        assert r["roofline"]["collective_s"] == 0.0


@pytest.mark.parametrize("arch,shape,reduced", [
    ("gatedgcn", "ogb_products", True), ("meshgraphnet", "ogb_products", False),
    ("olmoe-1b-7b", "train_4k", False), ("yi-34b", "decode_32k", False),
    ("phi3.5-moe-42b-a6.6b", "long_500k", False), ("qwen2-1.5b", "decode_32k", False)])
def test_a_refused_cell_is_a_record_with_its_bytes(arch, shape, reduced):
    recs = dryrun.run_cell(arch, shape, (False, True), reduced=reduced, device="cpu")
    for r in recs:
        assert not r["ok"] and "step_s" not in r and "out_of_memory" not in r
        assert "does not fit one card" in r["refused"]
        assert r["refusal_bytes"] > steps.CARD_BYTES
        assert f"{r['refusal_bytes']:,}" in r["refused"]
        assert r["memory"]["argument_bytes"] > 0


def test_serving_cells_refuse_by_weights_and_cache():
    cfg = steps.get_arch("qwen2-1.5b").config()
    assert steps.lm_serve_bytes(cfg, 1, 524288) == 18_586_561_536  # 3.55 GB + 15.03 GB
    with pytest.raises(steps.CellRefused) as e:
        steps.build_cell("qwen2-1.5b", "decode_32k", device="cpu")
    assert e.value.nbytes == steps.lm_serve_bytes(cfg, 128, 32768) > steps.CARD_BYTES
    assert isinstance(e.value, ValueError)


def test_running_out_of_memory_is_a_record_not_a_failure(monkeypatch, tmp_path):
    real = steps.build_cell

    def build(*a, **kw):
        cell = real(*a, **kw)

        def boom(*_):
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 18.75 GiB")

        cell.fn = boom
        return cell

    monkeypatch.setattr(dryrun, "build_cell", build)
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "gcn-cora", "--shape", "molecule", "--reduced", "--device",
                        "cpu", "--out", str(out)]) == 0
    r = json.loads(out.read_text())
    assert not r["ok"] and "Tried to allocate 18.75 GiB" in r["out_of_memory"]


def test_a_fault_is_recorded_and_fails_the_run(monkeypatch, tmp_path, capsys):
    def build(*a, **kw):
        raise RuntimeError("a fault of the port")

    monkeypatch.setattr(dryrun, "build_cell", build)
    out = tmp_path / "r.json"
    assert dryrun.main(["--arch", "gcn-cora", "--shape", "molecule", "--reduced", "--device",
                        "cpu", "--multi-pod", "--out", str(out)]) == 1
    r = json.loads(out.read_text())
    assert not r["ok"] and r["error"] == "RuntimeError: a fault of the port"
    assert r["mesh"] == "pod2x16x16"
    assert "1 failed" in capsys.readouterr().out


def test_the_check_sees_the_cell_and_its_output():
    seen = {}

    def check(cell, out):
        seen["model"] = type(cell.model).__name__
        return {"loss": float(out[0])}

    r = dryrun.run_cell("gcn-cora", "full_graph_sm", reduced=True, device="cpu", check=check)[0]
    assert seen == {"model": "GCN"} and r["check"]["loss"] > 0


def test_resident_bytes_count_each_storage_once():
    cell = steps.build_cell("qwen2-1.5b", "long_500k", reduced=True, device="cpu")
    weights = sum(p.numel() * p.element_size() for p in cell.model.parameters())
    cache = sum(c.numel() * c.element_size() for c in cell.args[0])
    tokens = cell.args[1].numel() * cell.args[1].element_size()
    assert dryrun.resident_bytes(cell, torch.device("cpu")) == weights + cache + tokens


def test_importing_the_dry_run_sets_no_environment_variable():
    code = ("import os; before = dict(os.environ); import repro_torch.launch.dryrun; "
            "assert dict(os.environ) == before, set(os.environ) ^ set(before); print('OK')")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "OK", proc.stderr


@pytest.mark.parametrize("flags,shape", [([], {"data": 16, "model": 16}),
                                         (["--multi-pod"], {"pod": 2, "data": 16, "model": 16}),
                                         (["--host-mesh"], {"data": 1, "model": 1})])
def test_the_trainer_takes_the_mesh_flags(flags, shape, capsys):
    res = lm_train.main(["--arch", "qwen2-1.5b", "--reduced", "--steps", "1", "--device",
                         "cpu", *flags])
    assert res["mesh"].shape == shape and len(res["losses"]) == 1
    assert f"mesh {shape}" in capsys.readouterr().out
