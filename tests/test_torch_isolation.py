"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the card unless the CPU is asked for.

The import check runs in a subprocess: this test process has JAX loaded
already (``conftest.py``).
"""

import ast
import dataclasses
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import distributed_tensorflow_example_tpu_torch as port
from distributed_tensorflow_example_tpu_torch.models.gpt import (
    GPT, GPTConfig, params_from_numpy, params_to_numpy)
from distributed_tensorflow_example_tpu_torch.runtime.device import \
    resolve_device
from distributed_tensorflow_example_tpu_torch.serving import (
    export_generator, load_servable, load_stepwise)
from distributed_tensorflow_example_tpu_torch.serving_http import \
    PredictServer

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(port.__file__))
FORBIDDEN = ("jax", "jaxlib", "distributed_tensorflow_example_tpu")
TINY = GPTConfig(vocab_size=64, hidden=32, layers=1, heads=2,
                 intermediate=64, max_len=32)


def _port_modules() -> list[str]:
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _port_sources() -> list[str]:
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


#: the engine slice's modules, named so that the walk below is shown to
#: reach them
ENGINE_MODULES = tuple(
    f"distributed_tensorflow_example_tpu_torch.{m}" for m in (
        "obs.registry", "obs.trace", "runtime.faults", "serving_batch",
        "ops.cuda.paged_decode_attention"))
#: the modules of the rest of training (adafactor, best checkpoints, async
#: saves, rollback, the fault seams and the summary, timing, profiler and
#: trace sinks), named likewise
TRAINING_MODULES = tuple(
    f"distributed_tensorflow_example_tpu_torch.{m}" for m in (
        "utils.tb_events", "utils.metrics", "ckpt.checkpoint",
        "train.hooks", "train.trainer", "train.optimizers", "data.loader",
        "cli.train"))


#: the single server's operator surface (the predict path, the obs sinks,
#: the chaos soak and the trace summary), named likewise
SERVER_MODULES = tuple(
    f"distributed_tensorflow_example_tpu_torch.{m}" for m in (
        "obs.prom", "obs.timeseries", "obs.slo", "obs.flightrec",
        "serving_http", "utils.trace_summary",
        "experiments.serving_chaos"))


#: the serving fleet (the router, the stitcher, servetop, the fleet chaos
#: drills and the load harness), named likewise
FLEET_MODULES = tuple(
    f"distributed_tensorflow_example_tpu_torch.{m}" for m in (
        "obs.stitch", "serving_router", "tools.servetop",
        "experiments.fleet_chaos", "experiments.serving_load"))


#: MoE-BERT and the training-state knobs (the MoE FFN, the model, warm
#: start), named likewise
MOE_MODULES = tuple(
    f"distributed_tensorflow_example_tpu_torch.{m}" for m in (
        "ops.moe", "models.moe", "ckpt.warm_start"))


#: the file readers (TFRecord, the C++ loader, the ImageNet readers and
#: the streaming pipeline, the text corpus, the TF checkpoint import and
#: the training chaos soak), named likewise
READER_MODULES = tuple(
    f"distributed_tensorflow_example_tpu_torch.{m}" for m in (
        "data.tfrecord", "data.native", "data.imagenet", "data.streaming",
        "data.bert_text", "ckpt.tf_import", "experiments.chaos_soak"))
#: the fsdp axis (the mesh over ranks, the named collectives, the sharding
#: rules) and the repo's two other example scripts, named likewise
SHARDED_MODULES = tuple(
    f"distributed_tensorflow_example_tpu_torch.{m}" for m in (
        "parallel.mesh", "parallel.collectives", "parallel.sharding",
        "parallel.sync_replicas", "parallel.tensor_parallel",
        "examples.finetune_export", "examples.train_and_generate",
        # ring attention over seq, the GPipe pipeline over pipe and the
        # pipe models
        "parallel.ring_attention", "parallel.pipeline", "models.pipe_mlp",
        "models.pipe_bert",
        # the expert-parallel pipeline model (EP x PP)
        "models.pipe_moe"))
#: imported only inside the functions that decode, tokenize or read a TF
#: checkpoint: the card's machine has none of them
OPTIONAL = ("PIL", "transformers", "tensorflow")


def test_importing_every_module_loads_no_jax():
    """Every port module imports in a process where JAX, the reference
    package, Pillow, transformers and TensorFlow cannot be imported (an
    import hook refuses them and records the attempt): none loads, none
    is even tried."""
    mods = _port_modules()
    assert len(mods) >= 20, mods
    assert set(ENGINE_MODULES) <= set(mods), mods
    assert set(TRAINING_MODULES) <= set(mods), mods
    assert set(SERVER_MODULES) <= set(mods), mods
    assert set(FLEET_MODULES) <= set(mods), mods
    assert set(MOE_MODULES) <= set(mods), mods
    assert set(READER_MODULES) <= set(mods), mods
    assert set(SHARDED_MODULES) <= set(mods), mods
    blocked = FORBIDDEN + OPTIONAL
    code = (
        "import importlib, importlib.abc, sys\n"
        "tried = []\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {blocked!r}:\n"
        "            tried.append(name)\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{blocked!r})\n"
        "print('FORBIDDEN', bad)\n"
        "print('TRIED', sorted(set(tried)))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "FORBIDDEN []" in out.stdout, out.stdout
    assert "TRIED []" in out.stdout, out.stdout


def test_quantized_paths_run_without_jax(tmp_path):
    """The int8 paths run in a process that holds no JAX: an export with
    int8 weights and an int8 KV pool, its stepwise loader and engine
    (quantize-on-write, the int8 paged attention's plain version), and
    ``generate(weight_quant="int8")``."""
    code = (
        "import sys, numpy as np, torch\n"
        "from distributed_tensorflow_example_tpu_torch.models.gpt import (\n"
        "    GPT, GPTConfig)\n"
        "from distributed_tensorflow_example_tpu_torch.serving import (\n"
        "    export_generator, load_stepwise)\n"
        "from distributed_tensorflow_example_tpu_torch.serving_batch \\\n"
        "    import GenerationEngine\n"
        f"m = GPT(GPTConfig(**{dataclasses.asdict(TINY)!r}))\n"
        "p = m.init(0, device='cpu')\n"
        f"export_generator(m, p, {str(tmp_path)!r}, prompt_len=4,\n"
        "    max_new_tokens=2, stepwise=True, slots=2, paged=True,\n"
        "    block_size=2, weight_quant='int8', kv_cache_dtype='int8')\n"
        f"eng = GenerationEngine(load_stepwise({str(tmp_path)!r}, "
        "device='cpu'))\n"
        "f = eng.submit(np.array([1, 2, 3], np.int32))\n"
        "eng.start()\n"
        "out = f.result(timeout=60)\n"
        "eng.close()\n"
        "toks = m.generate(p, torch.tensor([[1, 2, 3]]), 2,\n"
        "                  weight_quant='int8')\n"
        "print('SHAPES', len(out), tuple(toks.shape),\n"
        "      eng.stats()['kv_cache_dtype'])\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "SHAPES 2 (1, 2) int8" in out.stdout, out.stdout
    assert "FORBIDDEN []" in out.stdout, out.stdout


#: the training slice's modules, named so that the walk above is shown
#: to reach them
TRAIN_MODULES = tuple(
    f"distributed_tensorflow_example_tpu_torch.{m}" for m in (
        "ops.losses", "train.optimizers", "train.state",
        "parallel.sync_replicas"))


def test_training_step_runs_without_jax():
    """``SyncReplicas.init`` and ``step`` (AdamW, clip, GPT loss through
    the flash Function's plain versions, dropout on) run in a process
    that holds no JAX, and every training module is in the walk of
    :func:`test_importing_every_module_loads_no_jax`."""
    assert set(TRAIN_MODULES) <= set(_port_modules())
    code = (
        "import sys, numpy as np\n"
        "from distributed_tensorflow_example_tpu_torch.config import \\\n"
        "    OptimizerConfig\n"
        "from distributed_tensorflow_example_tpu_torch.models.gpt import (\n"
        "    GPT, GPTConfig)\n"
        "from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas"
        " import SyncReplicas\n"
        "from distributed_tensorflow_example_tpu_torch.train.optimizers "
        "import make_optimizer\n"
        f"m = GPT(GPTConfig(**{dataclasses.asdict(TINY)!r}), "
        "attention_impl='flash')\n"
        "tx = make_optimizer(OptimizerConfig(name='adamw', "
        "learning_rate=1e-2, grad_clip_norm=1.0, weight_decay=0.01))\n"
        "sync = SyncReplicas(m.loss, tx, device='cpu')\n"
        "state = sync.init(m.init, seed=0)\n"
        "ids = np.arange(16, dtype=np.int32).reshape(2, 8) % 64\n"
        "for _ in range(3):\n"
        "    state, met = sync.step(state, {'input_ids': ids})\n"
        "print('STEP', state.step, int(met['anomaly_count']),\n"
        "      bool(np.isfinite(float(met['loss']))))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "STEP 3 0 True" in out.stdout, out.stdout
    assert "FORBIDDEN []" in out.stdout, out.stdout


#: the trainer slice's modules, named so that the walk of
#: :func:`test_importing_every_module_loads_no_jax` is shown to reach them
TRAINER_MODULES = tuple(
    f"distributed_tensorflow_example_tpu_torch.{m}" for m in (
        "cli.train", "train.trainer", "train.hooks", "data.bert_data",
        "data.loader", "cluster", "runtime.server", "utils.metrics",
        "ckpt.checkpoint"))


def test_training_cli_runs_without_jax(tmp_path):
    """``cli/train.main`` trains gpt_tiny on the CPU (fused flash backward,
    a checkpoint, a resume), and the ps role exits 0, in a process that
    holds no JAX; every trainer module is in the import walk."""
    assert set(TRAINER_MODULES) <= set(_port_modules())
    ck = str(tmp_path / "ck")
    argv = ["--model", "gpt_tiny", "--device", "cpu", "--seq_len", "16",
            "--batch_size", "2", "--optimizer", "adamw", "--attention",
            "flash", "--attention_bwd", "fused", "--ckpt_dir", ck,
            "--save_steps", "2", "--log_every_steps", "2"]
    code = (
        "import sys\n"
        "from distributed_tensorflow_example_tpu_torch.cli.train import "
        "main\n"
        f"a = main({argv!r} + ['--train_steps', '2'])\n"
        f"b = main({argv!r} + ['--train_steps', '4'])\n"
        "c = main(['--job_name', 'ps'])\n"
        "print('RC', a, b, c)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "RC 0 0 0" in out.stdout, out.stdout
    assert "FORBIDDEN []" in out.stdout, out.stdout
    assert "restored checkpoint at step 2" in out.stderr
    assert sorted(os.listdir(ck)) == ["checkpoint", "ckpt-2.npz",
                                      "ckpt-4.npz"]


#: the MNIST slice's modules, named so that the walk of
#: :func:`test_importing_every_module_loads_no_jax` is shown to reach them
MNIST_MODULES = tuple(
    f"distributed_tensorflow_example_tpu_torch.{m}" for m in (
        "data.mnist", "models.mlp", "runtime.distributed",
        "examples.mnist_distributed"))


def test_mnist_example_runs_without_jax(tmp_path):
    """The port's copy of the example trains the MLP on the CPU, saves,
    resumes, and its ps branch exits 0, in a process that holds no JAX;
    every MNIST module is in the import walk."""
    assert set(MNIST_MODULES) <= set(_port_modules())
    ck = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--ckpt_dir", ck, "--log_every_steps", "20"]
    code = (
        "import sys\n"
        "from distributed_tensorflow_example_tpu_torch.examples."
        "mnist_distributed import main\n"
        f"a = main({argv!r} + ['--train_steps', '20'])\n"
        f"b = main({argv!r} + ['--train_steps', '40'])\n"
        "c = main(['--job_name', 'ps', '--worker_hosts', 'w0:1,w1:1'])\n"
        "print('RC', a, b, c)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "RC 0 0 0" in out.stdout, out.stdout
    assert "FORBIDDEN []" in out.stdout, out.stdout
    assert "restored checkpoint at step 20" in out.stdout
    assert sorted(os.listdir(ck)) == ["checkpoint", "ckpt-20.npz",
                                      "ckpt-40.npz"]


def test_example_scripts_run_without_jax(tmp_path):
    """The port's copies of ``examples/finetune_export.py`` (pretrain,
    warm-started fine-tune with the EMA, export, ``load_servable``) and
    ``examples/train_and_generate.py`` (gpt_tiny: train, restore,
    generate) run on the CPU in a process that holds no JAX; both are in
    the import walk."""
    assert set(SHARDED_MODULES) <= set(_port_modules())
    code = (
        "import sys\n"
        "from distributed_tensorflow_example_tpu_torch.examples import (\n"
        "    finetune_export, train_and_generate)\n"
        f"out = finetune_export.run({str(tmp_path / 'ft')!r}, 20, 10,\n"
        "                          device='cpu')\n"
        "print('ACC', out['servable_accuracy_16'] > 0.9)\n"
        "rc = train_and_generate.main(['--workdir', "
        f"{str(tmp_path / 'lm')!r}, '--train_steps', '4',\n"
        "    '--new_tokens', '4', '--device', 'cpu'])\n"
        "print('RC', rc)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ACC True" in out.stdout and "RC 0" in out.stdout, out.stdout
    assert "greedy :" in out.stdout and "sampled:" in out.stdout
    assert "FORBIDDEN []" in out.stdout, out.stdout


def test_no_source_names_jax_or_the_jax_package():
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_no_module_imports_triton_or_builds_at_import():
    code = (
        "import sys\n"
        "import distributed_tensorflow_example_tpu_torch.models.gpt\n"
        "import distributed_tensorflow_example_tpu_torch.serving_http\n"
        "import distributed_tensorflow_example_tpu_torch.serving_batch\n"
        "print('TRITON', 'triton' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert "TRITON False" in out.stdout, out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without CUDA, also where the tests run beside a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_cuda_raise_instead_of_using_the_cpu(
        no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")
    model = GPT(TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0)
    params = model.init(0, device="cpu")
    assert params["wte"]["table"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy(model, params_to_numpy(params))
    export_generator(model, params, str(tmp_path), prompt_len=4,
                     max_new_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_servable(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PredictServer(str(tmp_path), port=0)
    with PredictServer(str(tmp_path), port=0, device="cpu") as srv:
        out = srv.generate({"inputs": {"input_ids": [[1, 2, 3, 4]]}})
    assert np.asarray(out["generations"]).shape == (1, 2)


def test_engine_entry_points_without_cuda_raise(no_cuda, tmp_path):
    """The stepwise export loads onto the card by default: without CUDA
    the engine's loader and a scheduler-on server raise; with
    ``device="cpu"`` they serve."""
    model = GPT(TINY)
    params = model.init(0, device="cpu")
    export_generator(model, params, str(tmp_path), prompt_len=4,
                     max_new_tokens=2, stepwise=True, slots=2, paged=True,
                     block_size=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_stepwise(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PredictServer(str(tmp_path), port=0)
    with PredictServer(str(tmp_path), port=0, device="cpu") as srv:
        assert srv.engine is not None
        out = srv.generate({"inputs": {"input_ids": [[1, 2, 3]]}})
    assert np.asarray(out["generations"]).shape == (1, 2)


def test_fleet_runs_without_jax(tmp_path):
    """A 2-replica router fleet serves a request in a process that holds
    no JAX, and the router module itself loads no torch kernel."""
    code = (
        "import sys, json, urllib.request, torch\n"
        "from distributed_tensorflow_example_tpu_torch.models.gpt import (\n"
        "    GPT, GPTConfig)\n"
        "from distributed_tensorflow_example_tpu_torch.serving import \\\n"
        "    export_generator\n"
        "from distributed_tensorflow_example_tpu_torch.serving_router \\\n"
        "    import InProcessFleet\n"
        f"m = GPT(GPTConfig(**{dataclasses.asdict(TINY)!r}))\n"
        "p = m.init(0, device='cpu')\n"
        f"export_generator(m, p, {str(tmp_path)!r}, prompt_len=4,\n"
        "    max_new_tokens=2, stepwise=True, slots=2, paged=True,\n"
        "    block_size=2)\n"
        f"with InProcessFleet({str(tmp_path)!r}, 2,\n"
        "        server_kw={'device': 'cpu'}) as f:\n"
        "    req = urllib.request.Request(\n"
        "        f'http://127.0.0.1:{f.port}/v1/models/{f.name}:generate',\n"
        "        data=json.dumps({'inputs': {'input_ids': [[1, 2]]}})\n"
        "        .encode())\n"
        "    out = json.loads(urllib.request.urlopen(req, timeout=60)\n"
        "                     .read())\n"
        "print('SERVED', out['served_by'], len(out['generations'][0]))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SERVED replica0 2" in out.stdout, out.stdout
    assert "FORBIDDEN []" in out.stdout, out.stdout


def test_fleet_entry_points_without_cuda_raise(no_cuda, tmp_path):
    """The fleet's replicas, the fleet chaos drills and the load harness
    run on the card by default: without CUDA they raise; with
    ``device="cpu"`` the fleet serves."""
    from distributed_tensorflow_example_tpu_torch.experiments import (
        fleet_chaos, serving_load)
    from distributed_tensorflow_example_tpu_torch.serving_router import \
        InProcessFleet
    model = GPT(TINY)
    params = model.init(0, device="cpu")
    export_generator(model, params, str(tmp_path), prompt_len=4,
                     max_new_tokens=2, stepwise=True, slots=2, paged=True,
                     block_size=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InProcessFleet(str(tmp_path), 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fleet_chaos.run_scenarios(["hedge_cancels_loser"], seed=0,
                                  export_dir=str(tmp_path), vocab=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving_load.main(["--smoke"])
    with InProcessFleet(str(tmp_path), 2,
                        server_kw={"device": "cpu"}) as fleet:
        assert [s.device.type for s in fleet.servers] == ["cpu", "cpu"]


def test_sync_replicas_without_cuda_raise(no_cuda):
    """The training step runs on the card by default: without CUDA
    ``SyncReplicas`` raises; with ``device="cpu"`` its ``init`` and
    ``step`` train on the CPU."""
    from distributed_tensorflow_example_tpu_torch.config import \
        OptimizerConfig
    from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas \
        import SyncReplicas
    from distributed_tensorflow_example_tpu_torch.train.optimizers import \
        make_optimizer
    model = GPT(TINY)
    tx = make_optimizer(OptimizerConfig(name="adamw", learning_rate=1e-2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyncReplicas(model.loss, tx)
    sync = SyncReplicas(model.loss, tx, device="cpu")
    state = sync.init(model.init, seed=0)
    assert state.params["wte"]["table"].device.type == "cpu"
    ids = np.arange(16, dtype=np.int32).reshape(2, 8)
    state, met = sync.step(state, {"input_ids": ids})
    assert state.step == 1 and int(met["anomaly_count"]) == 0


def test_moe_bert_trains_warm_starts_and_serves_without_jax(tmp_path):
    """``cli/train.main`` trains moe_bert_tiny on the CPU with the EMA and
    bf16 moments, warm-started from a bert_tiny run, exports the static
    forward and serves it, in a process that holds no JAX."""
    common = ["--device", "cpu", "--batch_size", "4", "--seq_len", "16",
              "--optimizer", "adamw", "--learning_rate", "1e-3",
              "--train_steps", "2", "--log_every_steps", "0"]
    bert, exp = str(tmp_path / "bert"), str(tmp_path / "exp")
    code = (
        "import sys\n"
        "from distributed_tensorflow_example_tpu_torch.cli.train import "
        "main\n"
        "from distributed_tensorflow_example_tpu_torch.serving_http import "
        "PredictServer\n"
        f"a = main(['--model', 'bert_tiny'] + {common!r} + ['--ckpt_dir', "
        f"{bert!r}, '--save_steps', '2'])\n"
        f"b = main(['--model', 'moe_bert_tiny'] + {common!r} + [\n"
        "    '--ema_decay', '0.9', '--ema_debias', '--moment_dtype',\n"
        f"    'bfloat16', '--warm_start', {bert!r}, '--export_dir', "
        f"{exp!r}])\n"
        f"with PredictServer({exp!r}, port=0, device='cpu',\n"
        "                   scheduler='on') as srv:\n"
        "    ids = [[5, 6, 7, 8]] * 2\n"
        "    out = srv.predict({'inputs': {'input_ids': [r * 32 for r in "
        "ids],\n"
        "        'token_type_ids': [[0] * 128] * 2,\n"
        "        'attention_mask': [[1] * 128] * 2,\n"
        "        'masked_positions': [list(range(8))] * 2}})\n"
        "print('RC', a, b, len(out['predictions']),\n"
        "      srv.batcher.static_batch)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print('FORBIDDEN', bad)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "RC 0 0 2 4" in out.stdout, out.stdout
    assert "FORBIDDEN []" in out.stdout, out.stdout
    assert "warm-start:" in out.stderr


def test_moe_entry_points_without_cuda_raise(no_cuda):
    """MoE-BERT's init and bridge land on the card by default: without
    CUDA they raise; with ``device="cpu"`` they build on the CPU."""
    from distributed_tensorflow_example_tpu_torch.models.moe import (
        MoeBert, MoeBertConfig)
    from distributed_tensorflow_example_tpu_torch.models.moe import \
        params_from_numpy as moe_from_numpy
    from distributed_tensorflow_example_tpu_torch.models.moe import \
        params_to_numpy as moe_to_numpy
    model = MoeBert(MoeBertConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0)
    params = model.init(0, device="cpu")
    assert params["layer_1"]["moe"]["w_in"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        moe_from_numpy(model, moe_to_numpy(params))
    assert moe_from_numpy(model, moe_to_numpy(params),
                          device="cpu")["layer_1"]["moe"]["router"][
        "kernel"].device.type == "cpu"


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result where there
    is no card, and in a directory that holds nothing else of the
    repository."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    for script, cwd in ((os.path.join(ROOT, "chip_smoke.py"), ROOT),
                        (str(alone), str(tmp_path))):
        out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0, out.stdout
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
