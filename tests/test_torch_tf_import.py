"""The port's TF-checkpoint import (``ckpt/tf_import.py``) against the JAX
package's, on Saver checkpoints written here with the installed
TensorFlow from a numpy seed: the variables read, the mapping detected in
both naming styles, the MLP's imported leaves equal to the reference's
import bit for bit, and the imported MLP's forward against the
reference's and the numpy oracle's (1e-5 of the largest logit: f32
matmuls summed in different orders); the refusals (unmatched key, wrong shape, missing
variable) as the reference's.
"""

import jax
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from distributed_tensorflow_example_tpu.ckpt import tf_import as jimp  # noqa: E402
from distributed_tensorflow_example_tpu.models.mlp import MLP as JMLP  # noqa: E402
from distributed_tensorflow_example_tpu_torch.ckpt import tf_import as timp  # noqa: E402
from distributed_tensorflow_example_tpu_torch.models.mlp import MLP  # noqa: E402
from distributed_tensorflow_example_tpu_torch.utils.pytree import flatten_dict  # noqa: E402

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)


def _save(path, vals: dict | list, global_step=None) -> str:
    """A v1 Saver checkpoint of ``vals`` (named, or anonymous Variables)."""
    v1 = tf.compat.v1
    g = v1.Graph()
    with g.as_default():
        if isinstance(vals, dict):
            for k, v in vals.items():
                v1.Variable(v, name=k)
        else:
            for v in vals:
                v1.Variable(v)
        saver = v1.train.Saver()
        with v1.Session() as sess:
            sess.run(v1.global_variables_initializer())
            return saver.save(sess, str(path / "model.ckpt"),
                              global_step=global_step)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    rs = np.random.RandomState(0)
    named = {"hid_w": rs.randn(784, 100).astype(np.float32) * 0.05,
             "hid_b": rs.randn(100).astype(np.float32) * 0.01,
             "sm_w": rs.randn(100, 10).astype(np.float32) * 0.05,
             "sm_b": rs.randn(10).astype(np.float32) * 0.01}
    anon = [rs.randn(64, 1024).astype(np.float32),
            rs.randn(1024).astype(np.float32),
            rs.randn(1024, 10).astype(np.float32),
            rs.randn(10).astype(np.float32)]
    d1 = tmp_path_factory.mktemp("named")
    d2 = tmp_path_factory.mktemp("anon")
    return ((_save(d1, named, 2000), str(d1), named),
            (_save(d2, anon), str(d2), anon))


def test_load_and_mapping_equal_the_reference(ckpts):
    for prefix, d, vals in ckpts:
        for src in (prefix, d):
            a = timp.load_tf_checkpoint(src)
            b = jimp.load_tf_checkpoint(src)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].tobytes() == b[k].tobytes()
            assert timp.mnist_mlp_mapping(a) == jimp.mnist_mlp_mapping(b)


@pytest.mark.parametrize("which", [0, 1])
def test_imported_mlp_equals_the_reference_and_its_forward(ckpts, which):
    prefix, _, vals = ckpts[which]
    arrays = timp.load_tf_checkpoint(prefix)
    mapping = timp.mnist_mlp_mapping(arrays)
    in_dim, hidden = arrays[mapping["fc1/kernel"]].shape
    model = MLP(in_dim=in_dim, hidden=hidden)
    template = model.init(0, device="cpu")
    params = timp.import_into(template, arrays, mapping)
    jmodel = JMLP(in_dim=in_dim, hidden=hidden, num_classes=10)
    jparams = jimp.import_into(jmodel.init(jax.random.PRNGKey(0)), arrays,
                               jimp.mnist_mlp_mapping(arrays))
    flat = flatten_dict(params)
    for k, v in flatten_dict(jparams).items():
        assert flat[k].dtype == torch.float32 and flat[k].device.type == "cpu"
        assert flat[k].numpy().tobytes() == np.asarray(v).tobytes(), k
    x = np.random.RandomState(1).rand(4, in_dim).astype(np.float32)
    got = model.apply(params, {}, {"x": torch.from_numpy(x)})[0].numpy()
    want = np.asarray(jmodel.apply(jparams, {}, {"x": jax.numpy.asarray(
        x)})[0])
    # f32 sums of up to 1024 products in different orders: 1e-5 of the
    # largest logit
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    w1, b1, w2, b2 = (arrays[mapping[k]] for k in (
        "fc1/kernel", "fc1/bias", "fc2/kernel", "fc2/bias"))
    oracle = np.maximum(x @ w1 + b1, 0.0) @ w2 + b2
    np.testing.assert_allclose(got, oracle, rtol=0,
                               atol=1e-5 * np.abs(oracle).max())


def test_refusals_equal_the_reference(ckpts):
    prefix, _, _ = ckpts[0]
    arrays = timp.load_tf_checkpoint(prefix)
    template = MLP(hidden=50).init(0, device="cpu")        # wrong hidden
    with pytest.raises(ValueError, match="shape"):
        timp.import_into(template, arrays, timp.mnist_mlp_mapping(arrays))
    with pytest.raises(KeyError, match="does not contain"):
        timp.import_into(template, arrays, {"fc1/kernel": "nope"})
    with pytest.raises(KeyError, match="match no path"):
        timp.import_into(template, arrays, {"params/fc1/kernel": "hid_w"})
    out = timp.import_into(template, arrays, {"fc1/kernel": "nope"},
                           allow_missing=True)
    assert torch.equal(out["fc1"]["kernel"], template["fc1"]["kernel"])
    with pytest.raises(ValueError, match="cannot identify"):
        timp.mnist_mlp_mapping({"a": np.zeros(3)})
    bf16 = MLP(param_dtype=torch.bfloat16).init(0, device="cpu")
    out = timp.import_into(bf16, arrays, timp.mnist_mlp_mapping(arrays))
    assert out["fc2"]["bias"].dtype == torch.bfloat16
    assert torch.equal(out["fc2"]["bias"], torch.from_numpy(
        arrays["sm_b"]).to(torch.bfloat16))
