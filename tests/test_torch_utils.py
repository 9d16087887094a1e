"""The port's ``utils/`` against the JAX package's, on the CPU: the divide and
padding math, the log level and rank filter, the metrics line format, the
Chrome timeline, the profiler hooks. Every comparison is exact, apart from
wall-clock stamps, which are only checked to be present and ordered."""

import json
import logging

import pytest
import torch

from neuronx_distributed_tpu import utils as ju
from neuronx_distributed_tpu.utils import timeline as jtl
from neuronx_distributed_tpu_torch import utils as tu
from neuronx_distributed_tpu_torch.utils import logger as tlog
from neuronx_distributed_tpu_torch.utils import timeline as ttl


@pytest.mark.parametrize("a,b", [(12, 4), (7, 7), (0, 3), (9, 4), (5, 8)])
def test_divide_and_padding_match_jax(a, b):
    assert tu.pad_to_multiple(a, b) == ju.pad_to_multiple(a, b)
    if a % b:
        for mod in (tu, ju):
            with pytest.raises(ValueError, match="not divisible"):
                mod.divide(a, b)
    else:
        assert tu.divide(a, b) == ju.divide(a, b)


@pytest.mark.parametrize("name", ["off", "error", "warning", "info", "debug", "trace", "TRACE "])
def test_log_levels_match_jax(monkeypatch, name):
    monkeypatch.setenv("NXD_LOG_LEVEL", name)
    assert tu.get_log_level() == ju.get_log_level()


def test_logger_level_filter_and_format(monkeypatch, capsys):
    monkeypatch.setenv("NXD_LOG_LEVEL", "bogus")
    with pytest.raises(ValueError, match="NXD_LOG_LEVEL"):
        tu.get_log_level()
    monkeypatch.setenv("NXD_LOG_LEVEL", "warning")
    monkeypatch.setenv("NXD_LOG_HIDE_TIME", "1")
    monkeypatch.setattr(tlog, "_configured", {})
    log = tu.get_logger("nxd.test_utils")
    assert log is tu.get_logger("nxd.test_utils")
    log.info("hidden")
    log.warning("shown")
    monkeypatch.setattr(tu, "process_rank", lambda: 1)
    log.warning("rank 1")
    tu.get_logger("nxd.test_utils", rank0_only=False).warning("every rank")
    err = capsys.readouterr().err.splitlines()
    assert err == ["nxd.test_utils [WARNING] shown", "nxd.test_utils.allranks [WARNING] every rank"]
    logging.getLogger("nxd.test_utils").handlers.clear()
    logging.getLogger("nxd.test_utils.allranks").handlers.clear()


def test_metrics_writer_writes_jax_lines(tmp_path):
    recs = []
    for mod, name in ((ju, "jax.jsonl"), (tu, "port.jsonl")):
        w = mod.MetricsWriter(str(tmp_path / "m" / name))
        w.log(3, loss=torch.tensor(2.5) if mod is tu else 2.5, seqs_per_sec=7, tag="x")
        w.log(4, loss=1.25)
        w.close()
        recs.append([json.loads(line) for line in open(tmp_path / "m" / name)])
    for a, b in zip(*recs):
        assert list(a) == list(b) and a["time"] > 0
        assert {k: v for k, v in a.items() if k != "time"} == {
            k: v for k, v in b.items() if k != "time"}
    assert recs[1][0] == {**recs[1][0], "step": 3, "loss": 2.5, "seqs_per_sec": 7.0, "tag": "x"}
    tu.MetricsWriter(None).log(1, loss=1.0)


def test_throughput_window():
    t = tu.Throughput(batch_size=4, world_size=2, grad_accum_steps=3, window=2)
    assert t.seqs_per_step == 24
    assert t.get_throughput() > 0 and len(t.times) == 1
    t.get_throughput()
    t.get_throughput()
    assert len(t.times) == 2


def test_timeline_events_match_jax(tmp_path):
    files = []
    for mod, name, rank in ((jtl, "jax", 0), (ttl, "port", 0), (ttl, "port", 2)):
        path = str(tmp_path / name)
        with mod.Timeline(path, rank=rank) as tl:
            with mod.scope(tl, "load"):
                pass
            tl.mark_step_end()
            tl.mark_event_start("save")
            tl.mark_event_end("save")
        files.append(json.load(open(f"{path}.rank{rank}.json" if rank else f"{path}.json")))
    strip = lambda f: [{k: v for k, v in e.items() if k != "ts"} for e in f["traceEvents"]]  # noqa: E731
    assert strip(files[1]) == strip(files[0])
    assert {e["pid"] for e in files[2]["traceEvents"]} == {2}
    ts = [e["ts"] for e in files[1]["traceEvents"]]
    assert ts == sorted(ts)
    off = ttl.Timeline(None)
    off.mark_event_start("x")
    off.mark_step_end()
    assert off._events == []


def test_profiler_hooks(tmp_path):
    with tu.profile_steps(None):
        pass
    with tu.profile_steps(str(tmp_path / "prof")):
        with tu.step_annotation(5):
            torch.ones(8).sum()
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert any(e.get("name") == "train_step_5" for e in trace["traceEvents"])
