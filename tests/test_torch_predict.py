"""The forward's serving path on the port, held to the reference:
``serving.export_model`` of MLP, LeNet, BERT-tiny and GPT-tiny with the
reference's weights, the servable's logits against the reference's
``model.apply(..., train=False)`` at 1, 3 and 8 rows; the MicroBatcher's
buckets and counters against the reference's for the same submissions;
``:predict`` in row and columnar form with the reference's 400 cases;
``cli/train.py --export_dir`` end to end on the CPU."""

import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu import serving as jserving
from distributed_tensorflow_example_tpu.ckpt import checkpoint as jckpt
from distributed_tensorflow_example_tpu.config import TrainConfig as JConfig
from distributed_tensorflow_example_tpu.models import get_model as jget_model
from distributed_tensorflow_example_tpu.serving_batch import \
    MicroBatcher as JMicroBatcher
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as tckpt
from distributed_tensorflow_example_tpu_torch.cli import train as tcli
from distributed_tensorflow_example_tpu_torch.config import TrainConfig
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.models.mlp import MLP
from distributed_tensorflow_example_tpu_torch.serving import (
    export_model, load_servable, read_meta)
from distributed_tensorflow_example_tpu_torch.serving_batch import \
    MicroBatcher
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

#: the port's logits against the reference's, both f32 on the CPU: the two
#: differ only in summation order (measured <= 2e-6 of the largest logit)
LOGIT_RTOL = 1e-5
WAIT_S = 60                         # every HTTP and batcher wait's bound
ROWS = (1, 3, 8)


def _features(name: str, n: int, seed: int = 0) -> dict:
    """``n`` random rows of the model's serving features (ragged key masks
    with trailing pads for the transformers: the first row unpadded)."""
    rs = np.random.RandomState(seed + n)
    if name == "mlp":
        return {"x": rs.rand(n, 784).astype(np.float32)}
    if name == "lenet":
        return {"x": rs.rand(n, 28, 28, 1).astype(np.float32)}
    s = 16
    lens = rs.randint(s // 2, s + 1, n)
    lens[0] = s
    mask = (np.arange(s)[None] < lens[:, None]).astype(np.int32)
    ids = rs.randint(1, 1000, (n, s)).astype(np.int32)
    if name == "gpt_tiny":
        return {"input_ids": ids, "attention_mask": mask}
    return {"input_ids": ids, "token_type_ids": np.zeros((n, s), np.int32),
            "attention_mask": mask,
            "masked_positions": rs.randint(0, s // 2, (n, 3)).astype(
                np.int32)}


@pytest.fixture(scope="module", params=["mlp", "lenet", "bert_tiny",
                                        "gpt_tiny"])
def exported(request, tmp_path_factory):
    """(name, reference model, its params and extras, the port's export
    directory) with the reference's init weights bridged into the port."""
    name = request.param
    jm = jget_model(name, JConfig(model=name))
    out = jm.init(jax.random.key(0))
    jp, je = out if isinstance(out, tuple) else (out, {})
    tm = get_model(name, TrainConfig(model=name))
    tp = tckpt.from_numpy(jckpt._flatten(jax.device_get(jp)), "cpu")
    te = (tckpt.from_numpy(jckpt._flatten(jax.device_get(je)), "cpu")
          if je else {})
    d = str(tmp_path_factory.mktemp(f"export_{name}"))
    export_model(tm, tp, te, d, sample_batch=_features(name, 2))
    return name, jm, jp, je, d


@pytest.mark.parametrize("n", ROWS)
def test_servable_matches_reference_forward(exported, n):
    name, jm, jp, je, d = exported
    servable = load_servable(d, device="cpu")
    feats = _features(name, n, seed=1)
    got = servable(feats)
    want = np.asarray(jm.apply(jp, je, feats, train=False)[0])
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())


def test_export_metadata_has_the_references_keys(exported, tmp_path):
    """The port's export.json carries the reference's keys that mean
    something here, with the reference's values for the same model and
    sample batch, plus the config that rebuilds the model."""
    name, jm, jp, je, d = exported
    meta = read_meta(d)
    jd = str(tmp_path / "ref")
    jserving.export_model(jm, jp, je, jd, platforms=("cpu",),
                          sample_batch=_features(name, 2))
    with open(os.path.join(jd, "export.json")) as f:
        jmeta = json.load(f)
    for key in ("model", "input_signature", "param_count",
                "batch_polymorphic"):
        assert meta[key] == jmeta[key], key
    assert meta["kind"] == "forward"
    assert meta["model_config"]["name"] == name
    assert os.path.exists(os.path.join(d, "params.npz"))


def test_export_refuses_a_model_the_port_cannot_rebuild(tmp_path):
    """A model not built by ``get_model`` carries no recordable config;
    the refusal says so and names the models the port serves (every
    family is ported since slice A6d)."""
    m = MLP()
    with pytest.raises(ValueError, match="not built by models.get_model.*"
                                         "pipe_moe_bert"):
        export_model(m, m.init(0, device="cpu"), {}, str(tmp_path / "x"))
    assert not os.path.exists(tmp_path / "x")


# ---------------------------------------------------------------------------
# the MicroBatcher against the reference's
# ---------------------------------------------------------------------------

class _Doubler:
    """A servable returning 2x its rows (the batch it saw is recorded)."""

    def __init__(self):
        self.seen = []
        self.meta = {"batch_polymorphic": True}
        self.input_signature = {"x": {"shape": [8, 3], "dtype": "float32"}}

    def __call__(self, cols):
        self.seen.append(len(cols["x"]))
        return cols["x"] * 2.0


#: request sizes (rows): a mix under the batch cap of 8, and one with
#: a single request larger than the cap (its bucket rounds up past it)
SIZES = {"mixed": (3, 2, 4, 1, 5, 8, 2, 1, 1, 6),
         "oversized": (3, 11, 1, 2, 5, 1)}


def _batch_run(cls, sizes):
    """Queue the sizes before the batcher thread starts (deterministic
    gathering), then run them: (bucket sizes, stats, results)."""
    srv = _Doubler()
    mb = cls(srv, batch_max_size=8, batch_max_wait_ms=0.0)
    mb._running = True                    # accept submissions, no thread
    rs = np.random.RandomState(4)
    rows = [rs.rand(n, 3).astype(np.float32) for n in sizes]
    futs = [mb.submit({"x": r}, len(r)) for r in rows]
    mb._running = False
    mb.start()
    try:
        got = [f.result(timeout=WAIT_S) for f in futs]
        stats = {k: v for k, v in mb.stats().items() if "latency" not in k}
    finally:
        mb.close()
    for r, g in zip(rows, got):
        np.testing.assert_array_equal(np.asarray(g), r * 2.0)
    return srv.seen, stats


@pytest.mark.parametrize("case", sorted(SIZES))
def test_microbatcher_buckets_and_counters_match_reference(case):
    sizes = SIZES[case]
    seen, stats = _batch_run(MicroBatcher, sizes)
    jseen, jstats = _batch_run(JMicroBatcher, sizes)
    assert (seen, stats) == (jseen, jstats)
    assert stats["rows"] == sum(sizes) and stats["batches"] == len(seen)
    assert stats["padded_rows"] == sum(seen) - sum(sizes)
    cap = max(8, max(sizes))
    assert all(b & (b - 1) == 0 and b < 2 * cap for b in seen)


def test_microbatcher_pads_with_the_first_row_and_records_its_span():
    """A padded BERT-style row repeats the batch's first row (never a
    fully masked row), and the dispatch records ``predict_batch`` on the
    ``batcher`` lane."""
    from distributed_tensorflow_example_tpu_torch.obs import trace

    class Keep(_Doubler):
        def __call__(self, cols):
            self.cols = cols["x"].copy()
            return super().__call__(cols)

    srv = Keep()
    old = trace.recorder()
    rec = trace.set_recorder(trace.TraceRecorder(64))
    rec.start()
    mb = MicroBatcher(srv, batch_max_size=8, batch_max_wait_ms=0.0).start()
    try:
        x = np.arange(9, dtype=np.float32).reshape(3, 3)
        np.testing.assert_array_equal(
            np.asarray(mb.submit({"x": x}, 3).result(timeout=WAIT_S)), 2 * x)
    finally:
        mb.close()
        rec.stop()
        trace.set_recorder(old)
    assert len(srv.cols) == 4
    np.testing.assert_array_equal(srv.cols[3], x[0])
    spans = rec.drain()
    assert [(s[1], s[2], s[5]["rows"], s[5]["bucket"]) for s in spans] == \
        [("batcher", "predict_batch", 3, 4)]


# ---------------------------------------------------------------------------
# :predict over HTTP
# ---------------------------------------------------------------------------

def _post(port, name, payload, verb="predict"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:{verb}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def mlp_dir(tmp_path_factory):
    jm = jget_model("mlp", JConfig(model="mlp"))
    jp = jm.init(jax.random.key(0))
    tm = get_model("mlp", TrainConfig(model="mlp"))
    d = str(tmp_path_factory.mktemp("mlp"))
    export_model(tm, tckpt.from_numpy(jckpt._flatten(jax.device_get(jp)),
                                      "cpu"), {}, d)
    feats = _features("mlp", 3)
    return d, feats, np.asarray(jm.apply(jp, {}, feats, train=False)[0])


@pytest.mark.parametrize("scheduler", ["off", "on"])
def test_predict_rows_columns_and_bare_instances(mlp_dir, scheduler):
    d, feats, want = mlp_dir
    x = feats["x"]
    with PredictServer(d, device="cpu", scheduler=scheduler,
                       batch_max_wait_ms=1.0) as srv:
        assert (srv.batcher is not None) == (scheduler == "on")
        for payload in ({"instances": [{"x": r.tolist()} for r in x]},
                        {"inputs": {"x": x.tolist()}},
                        {"instances": x.tolist()}):
            out = _post(srv.port, srv.name, payload)
            np.testing.assert_allclose(np.asarray(out["predictions"]), want,
                                       rtol=0, atol=1e-5)
        for n in (1, 2):
            out = _post(srv.port, srv.name, {"inputs": {"x": x[:n].tolist()}})
            assert np.asarray(out["predictions"]).shape == (n, 10)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/stats", timeout=WAIT_S) as r:
            stats = json.loads(r.read())
    if scheduler == "on":
        assert stats["predict"]["rows"] == 3 * 3 + 1 + 2
    else:
        assert "predict" not in stats


BAD = [({}, "instances"),
       ({"instances": []}, "non-empty"),
       ({"instances": [{"y": [0.0]}]}, "missing model inputs"),
       ({"inputs": {"x": [[0.0, 1.0]]}}, "per-instance shape"),
       ({"inputs": {"x": [[0.0] * 784], "prompt_mask": [[1]]}},
        "unknown model inputs"),
       ({"instances": [{"x": [0.0] * 784}, {"x": [0.0] * 784, "z": 1}]},
        "differ from instance 0")]


@pytest.mark.parametrize("payload,frag", BAD)
def test_predict_bad_requests_are_400(mlp_dir, payload, frag):
    d, _, _ = mlp_dir
    with PredictServer(d, device="cpu", scheduler="on") as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, srv.name, payload)
        assert e.value.code == 400
        assert frag in json.loads(e.value.read())["error"]


def test_predict_routes_status_and_server_faults(mlp_dir):
    d, feats, _ = mlp_dir
    x = feats["x"]
    with PredictServer(d, device="cpu", name="mnist") as srv:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/v1/models/mnist",
                timeout=WAIT_S) as r:
            st = json.loads(r.read())
        assert st["model_version_status"][0]["state"] == "AVAILABLE"
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, srv.name, {"inputs": {"x": x.tolist()}},
                  verb="generate")
        assert e.value.code == 400
        assert ":predict" in json.loads(e.value.read())["error"]
        for exc in (RuntimeError("backend exploded"),
                    ValueError("platform mismatch")):
            def boom(f, seed=None, exc=exc):
                raise exc
            srv.servable = boom
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.port, srv.name, {"inputs": {"x": x.tolist()}})
            assert e.value.code == 500
            assert str(exc) in json.loads(e.value.read())["error"]


def test_bert_predict_over_rest_matches_reference(tmp_path):
    """A multi-input forward: row format zips the feature keys, the
    micro-batcher pads its bucket with the first row, and the answers are
    the reference's logits; bare instances are a 400."""
    jm = jget_model("bert_tiny", JConfig(model="bert_tiny"))
    jp = jm.init(jax.random.key(0))
    tm = get_model("bert_tiny", TrainConfig(model="bert_tiny"))
    d = str(tmp_path / "bert")
    export_model(tm, tckpt.from_numpy(jckpt._flatten(jax.device_get(jp)),
                                      "cpu"), {}, d,
                 sample_batch=_features("bert_tiny", 2))
    feats = _features("bert_tiny", 3, seed=5)
    want = np.asarray(jm.apply(jp, {}, feats, train=False)[0])
    with PredictServer(d, device="cpu", scheduler="on") as srv:
        rows = [{k: v[i].tolist() for k, v in feats.items()}
                for i in range(3)]
        out = _post(srv.port, srv.name, {"instances": rows})
        np.testing.assert_allclose(np.asarray(out["predictions"]), want,
                                   rtol=0, atol=LOGIT_RTOL
                                   * np.abs(want).max())
        assert srv.batcher.padded_rows == 1          # bucket 4 for 3 rows
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.port, srv.name, {"instances": [[1, 2, 3]]})
        assert e.value.code == 400


def test_cli_export_dir_serves_predict(tmp_path):
    """``cli/train.py --export_dir`` trains the MLP on the CPU, exports
    the forward and the port's server answers ``:predict`` with the
    offline servable's logits; the CLI's ``python -m ... serving_http``
    prints the predict route."""
    d = str(tmp_path / "exp")
    rc = tcli.main(["--model", "mlp", "--device", "cpu", "--batch_size",
                    "64", "--learning_rate", "0.5", "--train_steps", "20",
                    "--log_every_steps", "10", "--export_dir", d])
    assert rc == 0
    meta = read_meta(d)
    assert meta["kind"] == "forward" and meta["model"] == "mlp"
    assert meta["input_signature"]["x"]["shape"] == [8, 784]
    offline = load_servable(d, device="cpu")
    x = _features("mlp", 5, seed=9)["x"]
    want = offline({"x": x})
    with PredictServer(d, device="cpu", scheduler="on") as srv:
        out = _post(srv.port, srv.name, {"inputs": {"x": x.tolist()}})
    # the batcher ran the 5 rows in a bucket of 8: another GEMM shape,
    # another summation order
    np.testing.assert_allclose(np.asarray(out["predictions"], np.float32),
                               want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())
