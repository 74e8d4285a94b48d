"""The port's checkpoint format, generator export and HTTP server, on the
CPU, against the JAX package.

- npz: the reference's format (flat keys, per-array CRC32, bf16 as
  uint16 under ``__bf16__/``) crosses both ways with identical arrays
  and verified CRCs.
- serving: ``export_generator`` -> ``PredictServer(device="cpu")`` ->
  ``POST :generate`` answers the port's ``generate`` tokens, which equal
  the reference's (f32, greedy: exact), and refuses with a 400 every
  payload the reference's server refuses.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_tensorflow_example_tpu.ckpt.checkpoint import (
    _flatten, _load_npz_verified, _with_crcs)
from distributed_tensorflow_example_tpu.models.gpt import GPT as JGPT
from distributed_tensorflow_example_tpu.models.gpt import \
    GPTConfig as JGPTConfig
from distributed_tensorflow_example_tpu_torch.ckpt import checkpoint as ckpt
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.serving import (
    export_generator, load_servable)
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer
from test_torch_gpt import (SMALL, jax_generate, make_pair, prompts,
                            ragged_mask)

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, P, NEW = 3, 12, 6


def _post(port, name, payload, raw=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:generate",
        data=raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


@pytest.fixture(scope="module")
def pair():
    return make_pair()


@pytest.fixture(scope="module")
def greedy_server(pair, tmp_path_factory):
    _, _, tm, tp = pair
    d = str(tmp_path_factory.mktemp("greedy"))
    export_generator(tm, tp, d, prompt_len=P, max_new_tokens=NEW,
                     batch_size=B, ragged=True)
    with PredictServer(d, device="cpu", port=0) as srv:
        yield srv


@pytest.fixture(scope="module")
def sampled_server(pair, tmp_path_factory):
    _, _, tm, tp = pair
    d = str(tmp_path_factory.mktemp("sampled"))
    export_generator(tm, tp, d, prompt_len=P, max_new_tokens=NEW,
                     batch_size=B, temperature=0.8, top_k=20, top_p=0.9)
    with PredictServer(d, device="cpu", port=0) as srv:
        yield srv


# ---------------------------------------------------------------------------
# npz format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_npz_round_trips_both_ways(tmp_path, param_dtype):
    jm = JGPT(JGPTConfig(**SMALL), param_dtype=getattr(jnp, param_dtype))
    flat = _flatten(jm.init(jax.random.key(1)))
    if param_dtype == "bfloat16":
        assert all(k.startswith(ckpt.BF16_PREFIX) for k in flat)
    tm = GPT(GPTConfig(**SMALL), param_dtype=getattr(torch, param_dtype))

    # reference-written npz -> the port's reader (CRCs verified)
    ref_path = str(tmp_path / "ref.npz")
    with open(ref_path, "wb") as f:
        np.savez(f, **_with_crcs(flat))
    loaded = ckpt.load_npz(ref_path)
    params = params_from_numpy(tm, loaded, device="cpu")
    assert all(t.dtype == getattr(torch, param_dtype)
               for t in ckpt.flatten_dict(params).values())

    # the port's writer -> the reference's verified reader, unchanged
    port_path = ckpt.save_npz(str(tmp_path / "port.npz"),
                              params_to_numpy(params))
    back = _load_npz_verified(port_path)
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype
    for k, v in ckpt.load_npz(port_path).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_npz_crc_mismatch_is_refused(tmp_path):
    arrays = {"a/kernel": np.arange(12, dtype=np.float32).reshape(3, 4),
              "a/bias": np.ones(4, np.float32)}
    path = ckpt.save_npz(str(tmp_path / "x.npz"), arrays)
    with np.load(path) as z:
        members = {k: z[k] for k in z.files}
    members["a/bias"] = members["a/bias"] * 2        # stale CRC record
    with open(path, "wb") as f:
        np.savez(f, **members)
    with pytest.raises(ckpt.CorruptCheckpointError, match="CRC32"):
        ckpt.load_npz(path)
    with pytest.raises(ValueError, match="reserved"):
        ckpt.save_npz(str(tmp_path / "y.npz"), {ckpt.CRC_KEY: arrays["a/bias"]})


# ---------------------------------------------------------------------------
# export + server
# ---------------------------------------------------------------------------

def test_export_metadata_and_load(pair, greedy_server):
    meta = greedy_server.servable.meta
    assert meta["kind"] == "generator"
    assert meta["input_signature"] == {
        "input_ids": {"shape": [B, P], "dtype": "int32"},
        "prompt_mask": {"shape": [B, P], "dtype": "int32"}}
    for key in ("prompt_len", "max_new_tokens", "temperature", "top_k",
                "top_p", "eos_id", "pad_id", "ragged", "decode_impl",
                "quant_schema", "weight_quant"):
        assert key in meta, key
    _, _, tm, tp = pair
    servable = load_servable(greedy_server.servable.directory, device="cpu")
    assert servable.model.cfg == tm.cfg
    assert servable.model.dtype == tm.dtype
    for k, v in ckpt.flatten_dict(tp).items():
        assert torch.equal(ckpt.flatten_dict(servable.params)[k], v), k


@pytest.mark.parametrize("ragged", [False, True])
def test_served_tokens_equal_port_and_reference(pair, greedy_server,
                                                ragged):
    jm, jp, tm, tp = pair
    ids = prompts(B, P)
    mask = ragged_mask(B, P) if ragged else np.ones((B, P), np.int32)
    body = _post(greedy_server.port, greedy_server.name,
                 {"inputs": {"input_ids": ids.tolist(),
                             "prompt_mask": mask.tolist()}})
    got = np.asarray(body["generations"])
    port = tm.generate(tp, torch.from_numpy(ids), NEW,
                       prompt_mask=torch.from_numpy(mask)).numpy()
    ref = jax_generate(jm, jp, ids, NEW, mask)
    np.testing.assert_array_equal(got, port)
    np.testing.assert_array_equal(got, ref)
    # fewer instances than the exported batch: padded server-side, the
    # answer truncated; the "instances" spelling serves the same rows
    body = _post(greedy_server.port, greedy_server.name, {"instances": [
        {"input_ids": ids[i].tolist(), "prompt_mask": mask[i].tolist()}
        for i in range(2)]})
    np.testing.assert_array_equal(np.asarray(body["generations"]), got[:2])


def test_sampled_artifact_is_deterministic_per_seed(sampled_server):
    ids = prompts(B, P).tolist()
    a = _post(sampled_server.port, sampled_server.name,
              {"inputs": {"input_ids": ids}, "seed": 7})
    b = _post(sampled_server.port, sampled_server.name,
              {"inputs": {"input_ids": ids}, "seed": 7})
    c = _post(sampled_server.port, sampled_server.name,
              {"inputs": {"input_ids": ids}, "seed": 8})
    assert a == b and a != c
    for bad in ("7", True, 2 ** 63):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(sampled_server.port, sampled_server.name,
                  {"inputs": {"input_ids": ids}, "seed": bad})
        assert e.value.code == 400


def _ok_inputs():
    return {"input_ids": prompts(B, P).tolist(),
            "prompt_mask": np.ones((B, P), np.int32).tolist()}


@pytest.mark.parametrize("payload,match", [
    ({"inputs": _ok_inputs(), "stop_sequences": [[1]]}, "stop_sequences"),
    ({"inputs": _ok_inputs(), "spec_tokens": 2}, "spec_tokens"),
    ({"inputs": {"input_ids": [[1] * (P + 1)] * B,
                 "prompt_mask": [[1] * (P + 1)] * B}}, "exceeds"),
    ({"inputs": {"input_ids": _ok_inputs()["input_ids"],
                 "prompt_mask": [[0] * P] + [[1] * P] * (B - 1)}},
     "at least one real token"),
    ({"inputs": {"input_ids": _ok_inputs()["input_ids"]}}, "missing"),
    ({"inputs": {**_ok_inputs(), "foo": [[1]] * B}}, "unknown"),
    ({"inputs": {"input_ids": [[1] * P] * (B + 1),
                 "prompt_mask": [[1] * P] * (B + 1)}}, "static batch"),
    ({"prompts": [[1, 2]]}, "instances"),
    ([1, 2], "JSON object"),
    ({"inputs": {"input_ids": [[1] * (P - 1)] * B,
                 "prompt_mask": [[1] * (P - 1)] * B}}, "per-instance shape"),
])
def test_payload_errors_are_400(greedy_server, payload, match):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(greedy_server.port, greedy_server.name, payload)
    assert e.value.code == 400
    assert match in json.loads(e.value.read())["error"]


def test_routes_and_malformed_json(greedy_server):
    port, name = greedy_server.port, greedy_server.name
    status, health = _get(port, "/healthz")
    assert status == 200 and health["status"] == "live"
    assert health["device"] == "cpu" and health["scheduler"] == "off"
    status, st = _get(port, f"/v1/models/{name}")
    assert st["model_version_status"][0]["state"] == "AVAILABLE"
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nope")
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "other", {})
    assert e.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, name, None, raw=b"{not json")
    assert e.value.code == 400


@pytest.mark.parametrize("knob", [
    dict(stepwise=True), dict(stepwise=True, paged=True), dict(spec_tokens=4),
    dict(prefill_chunk=16), dict(weight_quant="int8"),
    dict(kv_cache_dtype="int8")])
def test_export_refuses_later_slices(pair, tmp_path, knob):
    """The stepwise export (slab and paged) writes the reference's
    ``stepwise`` metadata block; speculative verify, chunked prefill and
    the int8 paths still belong to a later slice and raise, writing
    nothing."""
    _, _, tm, tp = pair
    kw = dict(prompt_len=P, max_new_tokens=NEW)
    if not knob.get("stepwise"):
        with pytest.raises(NotImplementedError, match="later slice"):
            export_generator(tm, tp, str(tmp_path), **kw, **knob)
        assert not os.listdir(tmp_path)
        return
    export_generator(tm, tp, str(tmp_path), slots=3, **kw, **knob)
    with open(tmp_path / "export.json") as f:
        meta = json.load(f)
    sm = meta["stepwise"]
    c, total = tm.cfg, P + NEW
    assert meta["quant_schema"] == 1
    assert (sm["slots"], sm["prompt_len"], sm["max_new_tokens"],
            sm["max_context"]) == (3, P, NEW, total)
    assert sm["cache_dtype"] == sm["kv_cache_dtype"] == "float32"
    assert sm["paged"] is bool(knob.get("paged"))
    assert sm["spec_tokens"] == sm["prefill_chunk"] == 0
    shape = [c.layers, None, None, c.heads, c.hidden // c.heads]
    if not sm["paged"]:
        shape[1:3] = [3, total]
    else:
        per_row = -(-total // 16)
        assert (sm["block_size"], sm["blocks_per_slot"],
                sm["prompt_blocks"]) == (16, per_row, 1)
        assert sm["num_blocks"] == 1 + 3 * per_row        # + null block
        assert sm["layout"] == "left_aligned"
        shape[1:3] = [sm["num_blocks"], 16]
        with pytest.raises(ValueError, match="requires stepwise"):
            export_generator(tm, tp, str(tmp_path), paged=True, **kw)
    assert sm["pool_shape"] == shape


def test_scheduler_modes(pair, greedy_server, tmp_path):
    """``"on"`` builds the engine over a stepwise export and refuses a
    monolithic one; ``"auto"`` picks ``"on"`` exactly for a stepwise
    export."""
    d = greedy_server.servable.directory
    with PredictServer(d, device="cpu", scheduler="auto") as srv:
        assert srv.scheduler == "off" and srv.engine is None
    with pytest.raises(ValueError, match="stepwise"):
        PredictServer(d, device="cpu", scheduler="on")
    with pytest.raises(ValueError, match="scheduler"):
        PredictServer(d, device="cpu", scheduler="maybe")
    _, _, tm, tp = pair
    export_generator(tm, tp, str(tmp_path), prompt_len=P,
                     max_new_tokens=NEW, stepwise=True, slots=2)
    for mode in ("on", "auto"):
        with PredictServer(str(tmp_path), device="cpu",
                           scheduler=mode) as srv:
            assert srv.scheduler == "on" and srv.engine is not None
            out = srv.generate({"inputs": {"input_ids": [[1, 2, 3]]}})
        assert np.asarray(out["generations"]).shape == (1, NEW)


def test_cli_serves_until_sigterm(greedy_server):
    """``python -m ...serving_http --export_dir D --port 0 --device cpu``
    prints its URL, answers, and exits 0 on SIGTERM."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "distributed_tensorflow_example_tpu_torch.serving_http",
         "--export_dir", greedy_server.servable.directory, "--port", "0",
         "--device", "cpu"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving 'gpt' on http://"), line
        port = int(line.split("http://127.0.0.1:")[1].split("/")[0])
        status, _ = _get(port, "/healthz")
        assert status == 200
        body = _post(port, "gpt", {"inputs": _ok_inputs()})
        assert np.asarray(body["generations"]).shape == (B, NEW)
    finally:
        proc.terminate()
        rc = proc.wait(timeout=30)
    assert rc == 0, proc.stderr.read()
