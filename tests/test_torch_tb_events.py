"""The port's TensorBoard event files against the JAX package's writer and
TensorFlow's reader, on the CPU: CRC-32C test vectors, records byte-equal
to the reference writer's at a fixed ``wall_time`` (scalars, histograms,
the file-version header), the port's own reader (every record's masked
CRC checked, a damaged byte found), a round trip through TensorFlow's
``summary_iterator`` (skipped where ``tensorflow`` does not import),
non-finite histograms, and the ``MetricsLogger`` sink, ``SummaryHook``
and ``ParamHistogramHook`` through the Trainer and the CLI.

The counterparts of ``tests/test_tb_events.py``, held to the port.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.data.tfrecord import \
    crc32c as jcrc32c
from distributed_tensorflow_example_tpu.utils import tb_events as jtb
from distributed_tensorflow_example_tpu.utils.metrics import \
    MetricsLogger as JMetricsLogger
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.config import (
    DataConfig, ObservabilityConfig, TrainConfig)
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.train.trainer import Trainer
from distributed_tensorflow_example_tpu_torch.utils import tb_events as ttb
from distributed_tensorflow_example_tpu_torch.utils.metrics import \
    MetricsLogger
from distributed_tensorflow_example_tpu_torch.utils.pytree import \
    flatten_dict

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _records(path: str) -> list[bytes]:
    """Every framed record of a file, header and CRCs included."""
    with open(path, "rb") as f:
        data = f.read()
    out, off = [], 0
    while off < len(data):
        n = int.from_bytes(data[off:off + 8], "little")
        out.append(data[off:off + 16 + n])
        off += 16 + n
    return out


def test_crc32c_known_vectors():
    # RFC 3720 test vectors
    for data, want in ((b"", 0x0), (b"123456789", 0xE3069283),
                       (bytes(32), 0x8A9136AA),
                       (bytes(range(32)), 0x46DD794E)):
        assert ttb.crc32c(data) == want == jcrc32c(data)
    assert ttb.masked_crc32c(b"123456789") != ttb.crc32c(b"123456789")
    assert ttb.masked_crc32c(b"abc") == jtb._masked_crc(b"abc")


def test_records_are_byte_equal_to_the_reference_writer(tmp_path):
    """The same calls at the same wall times give the same bytes, record
    for record (the header's time is the file's own, so it is compared
    at a fixed time through the payload functions)."""
    rs = np.random.RandomState(0)
    vals = np.concatenate([rs.randn(500) * 3.0, [0.0, -7.5, np.inf]])
    files = {}
    for name, mod in (("port", ttb), ("jax", jtb)):
        w = mod.EventFileWriter(str(tmp_path / name))
        w.scalars(5, {"loss": 0.25, "accuracy": 0.875}, wall_time=123.5)
        w.scalar(2**40, "eval/loss", -1.5e-3, wall_time=124.0)
        w.histogram(6, "params/w", vals, wall_time=125.25)
        w.histogram(7, "params/empty", np.array([np.nan]),
                    wall_time=126.0)
        w.close()
        files[name] = _records(w.path)
    assert len(files["port"]) == len(files["jax"]) == 6
    assert files["port"][1:] == files["jax"][1:]
    assert ttb._file_version_event(99.0) == jtb._file_version_event(99.0)
    assert ttb.frame(b"x" * 300) == _records_of(jtb, b"x" * 300)


def _records_of(mod, payload: bytes) -> bytes:
    """One record framed by the reference writer's own ``_record``."""
    import io

    class _W(mod.EventFileWriter):
        def __init__(self):
            self._f = io.BytesIO()

    w = _W()
    w._record(payload)
    return w._f.getvalue()


def test_port_reader_checks_every_crc(tmp_path):
    w = ttb.EventFileWriter(str(tmp_path))
    w.scalars(3, {"a": 1.5, "b": -2.0}, wall_time=10.0)
    w.histogram(3, "h", np.arange(5.0), wall_time=10.0)
    w.close()
    assert ttb.read_scalars(w.path) == [(3, "a", 1.5, 10.0),
                                        (3, "b", -2.0, 10.0)]
    assert len(list(ttb.read_records(w.path))) == 4
    data = bytearray(open(w.path, "rb").read())
    data[-10] ^= 0xFF                      # inside the histogram payload
    bad = str(tmp_path / "bad")
    with open(bad, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        list(ttb.read_records(bad))
    with open(bad, "wb") as f:
        f.write(open(w.path, "rb").read()[:-3])
    with pytest.raises(ValueError, match="truncated"):
        list(ttb.read_records(bad))


@pytest.fixture(scope="module")
def tf():
    return pytest.importorskip("tensorflow")


def test_roundtrip_against_tensorflow_reader(tmp_path, tf):
    w = ttb.EventFileWriter(str(tmp_path))
    w.scalars(5, {"loss": 0.25, "accuracy": 0.875}, wall_time=123.5)
    w.scalar(6, "loss", 0.125, wall_time=124.0)
    w.close()
    events = list(tf.compat.v1.train.summary_iterator(w.path))
    assert events[0].file_version == "brain.Event:2"
    scalars = [(e.step, v.tag, v.simple_value, e.wall_time)
               for e in events[1:] for v in e.summary.value]
    assert sorted(scalars) == sorted([(5, "loss", 0.25, 123.5),
                                      (5, "accuracy", 0.875, 123.5),
                                      (6, "loss", 0.125, 124.0)])


def test_histogram_against_tensorflow_reader(tmp_path, tf):
    rs = np.random.RandomState(0)
    vals = np.concatenate([rs.randn(1000) * 2.0, [-7.5, 0.0, 9.25]])
    w = ttb.EventFileWriter(str(tmp_path))
    w.histogram(3, "weights/kernel", vals)
    w.close()
    histos = [(ev.step, v.tag, v.histo)
              for ev in tf.compat.v1.train.summary_iterator(w.path)
              for v in ev.summary.value if v.HasField("histo")]
    assert len(histos) == 1
    step, tag, h = histos[0]
    assert step == 3 and tag == "weights/kernel"
    assert h.min == pytest.approx(vals.min())
    assert h.max == pytest.approx(vals.max())
    assert h.num == pytest.approx(len(vals))
    assert h.sum == pytest.approx(vals.sum(), rel=1e-9)
    assert h.sum_squares == pytest.approx((vals ** 2).sum(), rel=1e-9)
    assert sum(h.bucket) == pytest.approx(len(vals))
    limits = list(h.bucket_limit)
    assert len(h.bucket) == len(limits)
    assert all(a < b for a, b in zip(limits, limits[1:]))


def test_histogram_nonfinite_values_stay_wellformed(tmp_path, tf):
    vals = np.array([1.0, np.nan, np.inf, -np.inf, 2.0])
    w = ttb.EventFileWriter(str(tmp_path))
    w.histogram(1, "w", vals)
    w.close()
    h = [v.histo for ev in tf.compat.v1.train.summary_iterator(w.path)
         for v in ev.summary.value if v.HasField("histo")][0]
    assert len(h.bucket) == len(h.bucket_limit)
    assert h.num == 2 and sum(h.bucket) == pytest.approx(2)
    jpath = str(tmp_path / "m.jsonl")
    logger = MetricsLogger(jpath)
    logger.log_histogram(1, "w", vals)
    logger.close()
    rec = [json.loads(line) for line in open(jpath)][0]
    assert rec["nonfinite"] == 3 and rec["count"] == 5
    assert rec["max"] == 2.0


def test_metrics_logger_tb_sink_matches_the_reference(tmp_path, tf):
    """The same records through both loggers: the same scalars (nested
    dicts flattened one level, strings and step-less records left out),
    and the JSONL lines equal but for the time."""
    recs = [{"step": 10, "loss": 1.5, "accuracy": np.float32(0.5),
             "eval": {"loss": 2.0}, "note": "not-a-number"},
            {"no_step_key": 1.0}]
    got = {}
    for name, cls in (("port", MetricsLogger), ("jax", JMetricsLogger)):
        ml = cls(str(tmp_path / name / "m.jsonl"),
                 tb_logdir=str(tmp_path / name / "tb"))
        for r in recs:
            ml.log(r)
        ml.log_histogram(11, "params/w", np.arange(10.0))
        ml.close()
        path, = glob.glob(str(tmp_path / name / "tb" / "events.*"))
        got[name] = sorted(
            (e.step, v.tag, round(v.simple_value, 6), v.HasField("histo"))
            for e in tf.compat.v1.train.summary_iterator(path)
            for v in e.summary.value)
        lines = [json.loads(x) for x in open(tmp_path / name / "m.jsonl")]
        got[name + "_jsonl"] = [{k: v for k, v in x.items() if k != "time"}
                                for x in lines]
    assert got["port"] == got["jax"]
    assert (10, "eval/loss", 2.0, False) in got["port"]
    assert len(got["port"]) == 4
    assert got["port_jsonl"] == got["jax_jsonl"]


def test_summary_and_histogram_hooks_end_to_end(tmp_path):
    """``summary_every_steps`` and ``param_histograms_every_steps``
    through the Trainer: the JSONL carries the step metrics and one
    histogram record per leaf at each cadence step, the event file the
    same scalars and HistogramProtos, every record's CRC valid."""
    data = synthetic_mnist(256, 64)
    jpath, tb = str(tmp_path / "m.jsonl"), str(tmp_path / "tb")
    cfg = TrainConfig(model="mlp", train_steps=4,
                      data=DataConfig(batch_size=64),
                      obs=ObservabilityConfig(
                          log_every_steps=0, metrics_path=jpath,
                          tb_logdir=tb, summary_every_steps=2,
                          param_histograms_every_steps=2))
    with Trainer(get_model("mlp", cfg), cfg,
                 {"x": data["train_x"], "y": data["train_y"]},
                 device="cpu") as tr:
        tr.train()
        n_leaves = len(flatten_dict(tr.state.params))
    recs = [json.loads(line) for line in open(jpath)]
    hrecs = [r for r in recs if "histogram" in r]
    assert sorted({r["step"] for r in hrecs}) == [2, 4]
    assert len(hrecs) == 2 * n_leaves
    assert all(r["histogram"].startswith("params/") for r in hrecs)
    assert [r["step"] for r in recs if "loss" in r and "histogram"
            not in r] == [2, 4]
    path, = glob.glob(os.path.join(tb, "events.out.tfevents.*"))
    assert len(list(ttb.read_records(path))) == 1 + 2 * n_leaves + 2 * 4
    tags = {t for _, t, _, _ in ttb.read_scalars(path)}
    assert tags == {"loss", "grad_norm", "accuracy", "anomaly_count"}


def test_cli_tb_logdir_summaries_and_histograms(tmp_path):
    tb = str(tmp_path / "tb")
    assert tcli.main(["--model", "gpt_tiny", "--device", "cpu",
                      "--seq_len", "32", "--batch_size", "4",
                      "--train_steps", "4", "--log_every_steps", "2",
                      "--tb_logdir", tb, "--summary_every_steps", "2",
                      "--param_histograms_every_steps", "4"]) == 0
    path, = glob.glob(os.path.join(tb, "events.out.tfevents.*"))
    scalars = ttb.read_scalars(path)
    assert {s for s, t, _, _ in scalars if t == "loss"} == {2, 4}
    assert any(t == "steps_per_sec" for _, t, _, _ in scalars)
    assert any(b"params/wte/table" in r for r in ttb.read_records(path))
