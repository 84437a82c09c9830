"""The port's quality sweep (``come_tpu_torch/tools/eval_sweep.py``,
``tools/build_eval_artifact.py``) against ``scripts/eval_sweep.py`` and
``scripts/build_eval_artifact.py``, and its committed artifact
``EVAL_gpu_r01.json``:

* ``heavy-tail-dcsbm``'s and ``low-snr-dcsbm``'s graphs bit for bit equal
  to ``come_tpu.graphs.dc_sbm_graph``'s;
* the resolved config of every registered dataset and heavy-tail, with and
  without ``--fast``, field by field equal to the one JAX's ``run_one``
  builds (its rule, ``scripts/eval_sweep.py:53-68``, written out here);
* build_eval_artifact's output on the same inputs equal to the JAX
  script's, but for ``platform`` and ``git``;
* the artifact's structure and floors: the JAX artifact's floors
  (``tests/test_eval_regression.py:24-33``, copied), the mesh rows at NMI
  >= 0.5, the port's bars of ``PERF.md`` §2, and ``platform`` and every
  row's ``device`` naming an NVIDIA card and its power limit;
* karate re-measured by the port's ``run_one`` on the CPU within 0.25 of
  the artifact's karate NMI, macro-F1 >= 0.8 (as the JAX package's slow
  ``test_karate_remeasures_within_band``).
"""

import dataclasses
import functools
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from come_tpu.config import PRESETS as J_PRESETS
from come_tpu.config import ComEConfig as JConfig
from come_tpu.graphs import dc_sbm_graph as j_dc_sbm
from come_tpu.graphs import get_dataset as j_get_dataset
from come_tpu_torch.graphs.datasets import DATASETS
from come_tpu_torch.tools import build_eval_artifact, eval_sweep

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
ARTIFACT = REPO / "EVAL_gpu_r01.json"

# tests/test_eval_regression.py:24-33, the JAX artifact's floors
EXPECTED_FLOORS = {
    "karate": {"nmi": 0.60, "macro_f1": 0.85},
    "blogcatalog-synthetic": {"nmi": 0.88, "macro_f1": 0.95},
    "wikipedia-synthetic": {"nmi": 0.90, "macro_f1": 0.95},
    "dblp-synthetic": {"nmi": 0.70, "macro_f1": 0.90},
    "flickr-synthetic": {"nmi": 0.90, "macro_f1": 0.95},
    "heavy-tail-dcsbm": {"nmi": 0.90, "macro_f1": 0.95},
    "synthetic-10m": {"nmi": 0.90, "macro_f1": 0.95},
}
# PERF.md §2's bars for the port: NMI >= 0.90 on blogcatalog and
# synthetic-10m on every tier and table dtype, macro-F1 >= 0.99 on
# blogcatalog, karate 0.5 (its per-pair preset)
PORT_BARS = {
    "karate": {"nmi": 0.5},
    "blogcatalog-synthetic": {"nmi": 0.90, "macro_f1": 0.99},
    "synthetic-10m": {"nmi": 0.90},
    "synthetic-10m-f32": {"nmi": 0.90},
}
# low-snr-dcsbm has no JAX artifact row: the port's NMI stays within this
# of the JAX package's CPU reading that chose the graph
LOW_SNR_BAND = 0.10
MESH_ROWS = {("karate", (2, 2)), ("dblp-synthetic", (2, 2)),
             ("blogcatalog-synthetic", (2, 2))}
CARD = re.compile(r"NVIDIA .+, \d+(\.\d+)? W$")


# ---------------------------------------------------------------- graphs


def _same_graph(g, jg):
    np.testing.assert_array_equal(g.indptr, jg.indptr)
    np.testing.assert_array_equal(g.indices, jg.indices)


def test_heavy_tail_graph_equals_jax():
    ds = eval_sweep._heavy_tail_dataset()
    jg, jlab = j_dc_sbm(5000, 12, avg_degree=30.0, exponent=2.5,
                        assortativity=25.0, seed=11)
    _same_graph(ds.graph, jg)
    np.testing.assert_array_equal(ds.labels, jlab)
    assert (ds.name, ds.num_communities) == ("heavy-tail-dcsbm", 12)


def test_low_snr_graph_equals_jax():
    a = eval_sweep.LOW_SNR["assortativity"]
    assert a in (8.0, 5.0, 3.0)
    ds, cfg = eval_sweep.resolve("low-snr-dcsbm", False)
    jg, jlab = j_dc_sbm(5000, 12, avg_degree=30.0, exponent=2.5,
                        assortativity=a, seed=11)
    _same_graph(ds.graph, jg)
    np.testing.assert_array_equal(ds.labels, jlab)
    assert cfg == eval_sweep.resolve("heavy-tail-dcsbm", False)[1]


# ---------------------------------------------------------------- configs


@functools.cache
def _jax_config(name: str, fast: bool):
    """The config ``scripts/eval_sweep.py::run_one`` builds (``:53-68``)."""
    if name == "heavy-tail-dcsbm":
        k, cfg = 12, J_PRESETS["blogcatalog"]
    else:
        k = j_get_dataset(name).num_communities
        cfg = J_PRESETS.get(name.lower().replace("-synthetic", ""),
                            JConfig())
    cfg = cfg.replace(num_communities=k)
    if fast:
        cfg = cfg.replace(outer_iters=2, pretrain_epochs=1,
                          walks_per_node=min(cfg.walks_per_node, 5))
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("name", sorted(DATASETS) + ["heavy-tail-dcsbm"])
def test_resolved_config_equals_jax(name, fast):
    _, cfg = eval_sweep.resolve(name, fast)
    assert dataclasses.asdict(cfg) == _jax_config(name, fast)


def test_extra_rows_configs():
    """The f32-table row differs from the synthetic-10m preset in the O1
    table dtype alone."""
    _, f32 = eval_sweep.resolve("synthetic-10m-f32", False)
    _, bf16 = eval_sweep.resolve("synthetic-10m", False)
    assert f32 == bf16.replace(walk_kernel_bf16_tables=False)
    assert bf16.walk_kernel_bf16_tables


# -------------------------------------------------------------- artifact


def test_build_eval_artifact_equals_jax_script(tmp_path):
    sys.path.insert(0, str(REPO / "scripts"))
    import build_eval_artifact as jax_build

    rows = [[{"dataset": "karate", "nmi": 0.7, "mesh": None}],
            [{"dataset": "dblp-synthetic", "nmi": 0.9, "mesh": [2, 2]},
             {"dataset": "x", "nmi": 0.5, "mesh": None}]]
    inputs = []
    for i, r in enumerate(rows):
        inputs.append(tmp_path / f"in{i}.json")
        inputs[-1].write_text(json.dumps(r))
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jout, pout = (tmp_path / d / "EVAL_x.json" for d in ("jax", "port"))
    jax_build.main(["--out", str(jout), "--inputs", *map(str, inputs),
                    "--platform", "tpu:x"])
    build_eval_artifact.main(["--out", str(pout), "--inputs",
                              *map(str, inputs), "--platform",
                              "NVIDIA H100 80GB HBM3, 700.00 W",
                              "--git", "abc1234"])
    want, got = (json.loads(p.read_text()) for p in (jout, pout))
    assert list(got) == list(want)
    for k in want:
        if k not in ("platform", "git"):
            assert got[k] == want[k], k
    assert got["platform"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert got["git"] == "abc1234"


def _artifact():
    return json.loads(ARTIFACT.read_text())


def _single_rows():
    return {r["dataset"]: r for r in _artifact()["results"]
            if not r.get("mesh")}


def test_artifact_structure():
    art = _artifact()
    assert list(art) == ["artifact", "protocol", "platform", "git",
                         "results"]
    assert art["artifact"] == ARTIFACT.name
    assert CARD.match(art["platform"]), art["platform"]
    rows = art["results"]
    assert len(rows) == 12
    single = _single_rows()
    assert set(single) == set(EXPECTED_FLOORS) | {"synthetic-10m-f32",
                                                  "low-snr-dcsbm"}
    mesh = {(r["dataset"], tuple(r["mesh"])) for r in rows if r["mesh"]}
    assert mesh == MESH_ROWS
    for r in rows:
        assert CARD.match(r["device"]), r
        for k in ("nodes", "edges", "communities", "nmi", "seconds",
                  "macro_f1", "micro_f1", "kernels", "o1_tier", "peak_mib"):
            assert k in r, (r["dataset"], k)
        # the per-pair tiers (karate's preset) run no kernel
        assert bool(r["kernels"]) != r["o1_tier"].endswith("per-pair"), r
        if r["mesh"]:
            assert r["backend"] in ("nccl", "gloo")
    for name in EXPECTED_FLOORS:
        assert set(single[name]["f1_by_train_ratio"]) == {
            "0.1", "0.3", "0.5", "0.7", "0.9"}
    assert single["synthetic-10m"]["o1_tables"] == "bfloat16"
    assert single["synthetic-10m-f32"]["o1_tables"] == "float32"
    low = single["low-snr-dcsbm"]
    assert low["assortativity"] == eval_sweep.LOW_SNR["assortativity"]
    assert low["jax_cpu_nmi"] == eval_sweep.LOW_SNR["jax_cpu_nmi"]
    assert 0.4 <= low["jax_cpu_nmi"] <= 0.85


@pytest.mark.parametrize("floors", [EXPECTED_FLOORS, PORT_BARS],
                         ids=["jax-artifact", "port-bars"])
def test_artifact_floors(floors):
    single = _single_rows()
    for name, bars in floors.items():
        for metric, floor in bars.items():
            val = single[name].get(metric)
            assert val is not None and np.isfinite(val), (name, metric)
            assert val >= floor, f"{name}.{metric}={val} < {floor}"


def test_artifact_mesh_and_low_snr_rows():
    for r in _artifact()["results"]:
        if r["mesh"]:
            assert r["nmi"] >= 0.5, r
    low = _single_rows()["low-snr-dcsbm"]
    assert low["nmi"] >= low["jax_cpu_nmi"] - LOW_SNR_BAND, low


def test_karate_remeasures_within_band_on_cpu():
    """The cheapest dataset end to end on the CPU against the artifact's
    card reading: a quality-class band, as the random streams differ."""
    want = _single_rows()["karate"]["nmi"]
    got = eval_sweep.run_one("karate", fast=False, mesh_shape=None,
                             device="cpu")
    assert np.isfinite(got["nmi"])
    assert got["nmi"] >= want - 0.25, (got["nmi"], want)
    assert got["macro_f1"] >= 0.8, got
    assert got["device"] == "cpu"
    assert got["peak_mib"] is None and got["held_mib"] is None
