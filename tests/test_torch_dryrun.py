"""``launch/dryrun.py`` and ``launch/report.py``: one rank of a cell run on
fake tensors through a ``CountingMesh``, its records, and the report.

The reference compiles its cells for 512 fake devices (``repro.launch.
dryrun``); the port runs a rank's step on fake tensors. Held here: a
reduced config's fake tallies equal the same step's on real ``(2, 2)``
CPU gloo ranks, each collective counted by ``CountingMesh.wrap`` while it
runs, kind for kind and call for call (train, prefill and decode of
reduced qwen3-4b, whose KV heads split, and decode of reduced gemma2-2b,
whose cache is gathered over ``model``); the argument bytes are the
rules' shard shapes and the parameter and moment bytes ``steps.
resident``'s; a step with data-dependent shapes (the MoE dispatch)
records ``None`` and the reason; one full-size cell (qwen3-4b
``decode_32k`` on ``16x16``) runs in at most 60 s; the report renders
its four sections from records in a temporary directory, ``-`` for
``None``.
"""
import json
import textwrap
import time

import numpy as np
import pytest

from repro_torch import configs as C
from repro_torch.launch import dryrun as D
from repro_torch.launch import partitioning as PT
from repro_torch.launch import report as RP
from repro_torch.lm.config import ShapeCell
from test_torch_model_axis import Group

CELLS = {("qwen3-4b", "train"): ShapeCell("t", 16, 8, "train"),
         ("qwen3-4b", "prefill"): ShapeCell("p", 16, 8, "prefill"),
         ("qwen3-4b", "decode"): ShapeCell("d", 32, 8, "decode"),
         ("gemma2-2b", "decode"): ShapeCell("d", 32, 8, "decode")}
MESH = PT.MeshShape(("data", "model"), (2, 2))

RANKS = """
    import pickle
    from repro_torch import configs as C
    from repro_torch.launch.mesh import launch_ranks
    import torch_mesh_probe as probe
    from test_torch_dryrun import CELLS
    if __name__ == "__main__":
        out = {key: launch_ranks(probe.dryrun_probe, 4, "cpu", dict(
                   cfg=C.get_reduced(key[0]), cell=cell, shape=(2, 2)),
                   timeout_s=120)
               for key, cell in CELLS.items()}
        with open(OUT, "wb") as f:
            pickle.dump(out, f)
    """


@pytest.fixture(scope="module")
def runs():
    g = Group("dryrun", textwrap.dedent(RANKS), 300)
    yield g
    g.stop()


def fake_record(arch, mode):
    return D.run_cell(arch, CELLS[arch, mode], False, verbose=False,
                      cfg=C.get_reduced(arch), mesh_shape=MESH)


@pytest.mark.parametrize("key", sorted(CELLS), ids=str)
def test_fake_tallies_equal_real_ranks(runs, key):
    rec = fake_record(*key)
    real = runs.result()[key]["ranks"][0]
    coll = rec["collectives"]
    assert real["reason"] == "" and rec["reason"] == ""
    for kind in D.KINDS:
        assert coll[f"coll_{kind}"] == real["tallies"][f"coll_{kind}"], kind
    assert coll["calls"] == real["tallies"]["calls"]
    assert coll["collective_bytes"] == sum(
        real["tallies"][f"coll_{k}"] for k in D.KINDS) > 0
    assert coll["coll_reduce-scatter"] == 0
    # the same FLOPs and outputs on fake and real tensors
    assert rec["cost"]["flops"] == real["flops"] > 0
    assert rec["memory"]["output_bytes"] == real["output_bytes"]
    assert rec["memory"]["argument_parts"] == real["argument_parts"]


def test_train_argument_bytes_are_resident(runs):
    """Rank 0's parameter and moment bytes in the record are what
    ``steps.resident`` finds it holding; the whole is the sum of the
    parts, each from the rules' shard shapes."""
    rec = fake_record("qwen3-4b", "train")
    res = runs.result()["qwen3-4b", "train"]["resident"][0]
    parts = rec["memory"]["argument_parts"]
    assert parts["params"] == res["params"]["bytes"] == \
        res["params"]["expected"]
    assert parts["moments"] == res["moments"]["bytes"]
    assert parts["step"] == 4
    assert parts["inputs"] == 2 * (8 // 2) * 16 * 4      # tokens, targets
    assert rec["memory"]["argument_bytes"] == sum(parts.values())


def test_decode_argument_bytes_hold_the_cache_shards():
    from repro_torch.launch import steps as ST
    from repro_torch.lm.model import TransformerLM
    from repro_torch.optim.adamw import tree_leaves
    cfg, cell = C.get_reduced("qwen3-4b"), CELLS["qwen3-4b", "decode"]
    rec = fake_record("qwen3-4b", "decode")
    part = PT.Partitioner(MESH, cfg, mode="decode")
    a_cache = TransformerLM(cfg, device="meta").init_cache(8, 32)
    want = sum(PT._prod(PT.shard_shape(MESH, s, c.shape)) * c.element_size()
               for c, s in zip(tree_leaves(a_cache),
                               ST.cache_specs(part, a_cache)))
    parts = rec["memory"]["argument_parts"]
    assert parts["caches"] == want > 0 and parts["moments"] == 0
    assert rec["memory"]["temp_bytes"] is None
    assert rec["compile_s"] is None and rec["lower_s"] > 0


def test_a_data_dependent_step_records_none():
    cfg = C.get_reduced("moonshot-v1-16b-a3b")
    rec = D.run_cell("moonshot-v1-16b-a3b", ShapeCell("t", 16, 8, "train"),
                     False, verbose=False, cfg=cfg, mesh_shape=MESH)
    assert rec["collectives"] is None and rec["roofline_raw"] is None
    assert rec["cost"] == {} and rec["mem_bytes_proxy"] is None
    assert "DynamicOutputShape" in rec["reason"]
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["model_flops"] > 0 and rec["model_flops_ratio"] is None


def test_full_size_cell_on_fake_tensors_in_a_minute(tmp_path):
    """qwen3-4b ``decode_32k`` on ``16x16``: rank 0 holds 1/16 of the
    heads' cache (head_dim split: 8 KV heads over 16) and 1/16 of the
    batch; the step gathers the cache over ``model``; the roofline terms
    come from the tallies and ``HW_H100``."""
    t0 = time.time()
    rec = D.run_cell("qwen3-4b", "decode_32k", False, verbose=False)
    assert time.time() - t0 < 60
    cfg = C.get_config("qwen3-4b")
    parts = rec["memory"]["argument_parts"]
    assert parts["caches"] == (2 * cfg.num_layers * (128 // 16) * 32768
                               * cfg.num_kv_heads * cfg.resolved_head_dim
                               // 16 * 2)
    coll = rec["collectives"]
    assert coll["coll_all-gather"] > parts["caches"]
    t = rec["roofline_raw"]
    assert t["t_collective_s"] == coll["collective_bytes"] / 450e9
    assert t["t_compute_s"] == coll["flops"] / 989e12
    assert t["total_flops"] == coll["flops"] * 256
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    path = D.save(rec, tmp_path)
    assert json.loads(path.read_text())["shape"] == "decode_32k"


def test_main_writes_records_and_report_renders(tmp_path, capsys,
                                                monkeypatch):
    """``dryrun.main`` with the reference's flags writes a record per cell
    and mesh; ``report.main`` renders the four sections from that
    directory, ``-`` for the fields the port cannot give."""
    cfg = C.get_reduced("qwen3-4b")
    monkeypatch.setattr(C, "get_config", lambda arch: cfg)
    monkeypatch.setitem(D.SHAPES, "decode_32k", CELLS["qwen3-4b", "decode"])
    D.main(["--arch", "qwen3-4b", "--shape", "decode_32k", "--both-meshes",
            "--out-dir", str(tmp_path), "--seq-shard-kv"])
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == ["qwen3-4b__d__16x16.json", "qwen3-4b__d__2x16x16.json"]
    rec = json.loads((tmp_path / names[0]).read_text())
    assert rec["part_kwargs"] == {"seq_shard_kv_decode": True}
    rec2 = D.run_cell("moonshot-v1-16b-a3b", ShapeCell("t", 16, 8, "train"),
                      False, verbose=False,
                      cfg=C.get_reduced("moonshot-v1-16b-a3b"),
                      mesh_shape=PT.MeshShape(("data", "model"), (16, 16)))
    D.save(rec2, tmp_path)
    capsys.readouterr()
    text = RP.main(["--dir", str(tmp_path)])
    for head in ("## Dry-run (3 records", "### mesh 16x16",
                 "### mesh 2x16x16", "## Roofline (single-pod 16x16)",
                 "### Collective breakdown", "### Hillclimb picks",
                 "- worst_fraction: qwen3-4b x d",
                 "- technique_rep: -"):
        assert head in text, head
    row = next(l for l in text.splitlines()
               if l.startswith("| moonshot-v1-16b-a3b | t | train"))
    assert row.count("| - ") >= 3
    assert RP.load("other", tmp_path) == []


def test_report_uses_the_h100_peak():
    rec = {"chips": 2, "model_flops": 2 * 989e12,
           "t_memory_model_s": 0.5,
           "roofline_raw": {"t_compute_s": 0.25, "t_collective_s": 0.1}}
    assert RP.roofline_fraction(rec) == pytest.approx(2.0)
    assert RP.roofline_fraction({"roofline_raw": None}) is None
    assert RP.fmt_s(None) == RP.fmt_bytes(None) == "-"
    assert np.isclose(RP.HW_H100.peak_flops, 989e12)
