"""The port's copies of the repo's two other example scripts, on the
CPU: ``examples/finetune_export.py`` meets what
``tests/test_example_script.py`` asks of the reference's (pretrain,
fine-tune and servable accuracy above 0.9), writes the artifact files
``export_model`` names, and its servable's logits equal the model's
forward on the fine-tuned EMA shadows, bit for bit (the same f32
weights, the same forward); ``examples/train_and_generate.py`` trains
gpt_tiny, restores it and prints greedy and sampled continuations, on
the plain attention it asks for."""

import os

import numpy as np
import torch

from distributed_tensorflow_example_tpu_torch.ckpt.checkpoint import \
    CheckpointManager
from distributed_tensorflow_example_tpu_torch.config import (
    OptimizerConfig, TrainConfig)
from distributed_tensorflow_example_tpu_torch.data.mnist import \
    synthetic_mnist
from distributed_tensorflow_example_tpu_torch.examples import (
    finetune_export, train_and_generate)
from distributed_tensorflow_example_tpu_torch.models import get_model
from distributed_tensorflow_example_tpu_torch.parallel.sync_replicas import \
    SyncReplicas
from distributed_tensorflow_example_tpu_torch.serving import load_servable
from distributed_tensorflow_example_tpu_torch.train.optimizers import (
    find_ema_params, make_optimizer)

torch.set_num_threads(1)


def test_finetune_export_lifecycle(tmp_path):
    out = finetune_export.run(str(tmp_path), pretrain_steps=40,
                              finetune_steps=30, device="cpu")
    assert out["pretrain_eval"]["accuracy"] > 0.9
    assert out["finetune_eval"]["accuracy"] > 0.9
    assert out["servable_accuracy_16"] > 0.9
    assert out["artifact"] == os.path.join(out["export_dir"], "export.json")
    assert os.path.exists(out["artifact"])
    assert os.path.exists(os.path.join(out["export_dir"], "params.npz"))
    # the servable serves the fine-tuned run's EMA shadows
    model = get_model("mlp", TrainConfig(model="mlp"))
    sync = SyncReplicas(model.loss, make_optimizer(OptimizerConfig(
        name="momentum", learning_rate=0.05, ema_decay=0.95)), device="cpu")
    state = CheckpointManager(str(tmp_path / "ft")).restore(
        sync.init(model.init, seed=0))
    assert state.step == 30
    ema = find_ema_params(state.opt_state, state.params)
    x = synthetic_mnist(2048, 512)["test_x"][:16]
    want, _ = model.apply(ema, state.extras, {"x": torch.from_numpy(x)},
                          train=False)
    got = load_servable(out["export_dir"], device="cpu")({"x": x})
    np.testing.assert_array_equal(np.asarray(got), want.detach().numpy())


def test_train_and_generate_example(tmp_path, capsys):
    rc = train_and_generate.main(["--workdir", str(tmp_path),
                                  "--train_steps", "8", "--new_tokens", "6",
                                  "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "greedy" in out and "sampled" in out
    assert "attention: xla for training and decode" in out
    rows = [ln for ln in out.splitlines() if ln.startswith("greedy :")]
    assert len(rows) == 2 and all(len(eval(r.split(":", 1)[1])) == 6
                                  for r in rows)
