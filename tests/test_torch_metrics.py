"""The port's meters, scalar sink and profiler trace on the CPU: the cases
of ``tests/test_metrics_plots.py:8-30`` on ``come_tpu_torch.metrics``, the
trainer's ``scalar_log`` and the CLI's ``--profile-dir``."""

import json
import time

import torch

from come_tpu_torch.config import get_config
from come_tpu_torch.graphs import get_dataset
from come_tpu_torch.main import main
from come_tpu_torch.metrics import ScalarLog, ThroughputMeter
from come_tpu_torch.metrics.profiling import annotate, trace
from come_tpu_torch.trainer import ComETrainer

torch.set_num_threads(2)


def test_throughput_meter():
    m = ThroughputMeter()
    with m.window(pairs=1000):
        time.sleep(0.01)
    with m.window(pairs=2000):
        time.sleep(0.01)
    assert m.total_pairs == 3000
    assert 0 < m.rate < 3000 / 0.02 * 2


def test_scalar_log_jsonl(tmp_path):
    p = tmp_path / "log.jsonl"
    log = ScalarLog(p)
    log.log(0, loss=1.5, nmi=0.2)
    log.log(1, loss=1.2, nmi=0.4)
    lines = [json.loads(ln) for ln in p.read_text().splitlines()]
    assert lines[0]["step"] == 0 and lines[0]["loss"] == 1.5
    assert lines[1]["nmi"] == 0.4
    assert len(log.records) == 2


def test_train_logs_one_record_per_outer_iteration(tmp_path):
    ds = get_dataset("karate")
    cfg = get_config("karate").replace(outer_iters=2, pretrain_epochs=1)
    slog = ScalarLog(tmp_path / "scalars.jsonl")
    hist = ComETrainer(ds.graph, cfg, "cpu").train(ds.labels,
                                                   scalar_log=slog)
    lines = [json.loads(ln)
             for ln in (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert len(lines) == len(slog.records) == len(hist) == 2
    for i, (rec, line) in enumerate(zip(hist, lines)):
        assert line["step"] == i
        assert set(line) == set(rec) | {"step", "time"}
        assert all(line[k] == rec[k] for k in rec)


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    out = tmp_path / "trace"
    assert main(["--device", "cpu", "--pretrain-epochs", "0",
                 "--outer-iters", "1", "--profile-dir", str(out)]) == 0
    files = list(out.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert "final NMI" in capsys.readouterr().out


def test_trace_is_a_no_op_without_a_dir():
    with trace(None), annotate("region"):
        assert torch.ones(2).sum() == 2
