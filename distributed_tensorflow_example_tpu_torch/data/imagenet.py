"""ImageNet, the synthetic set (an adapted copy of the synthetic part of
``distributed_tensorflow_example_tpu/data/imagenet.py``; numpy only).

ImageNet-shaped (224x224x3, 1000 classes) class-conditional textures, so
ResNet-50 trains and is measured without a dataset, array for array the
reference's. The folder (PIL) and TFRecord readers and the streaming
pipeline arrive with slice A5b-2.
"""

from __future__ import annotations

import numpy as np


def synthetic_imagenet(num_train: int = 512, num_test: int = 128,
                       num_classes: int = 1000, image_size: int = 224,
                       seed: int = 0, noise: float = 0.1
                       ) -> dict[str, np.ndarray]:
    """Low-resolution (16x16) prototypes upsampled to ``image_size`` plus
    noise, clipped to [0, 1]."""
    rs = np.random.RandomState(seed)
    small = rs.rand(num_classes, 16, 16, 3).astype(np.float32)
    reps = image_size // 16

    def draw(n, rstate):
        y = rstate.randint(0, num_classes, size=n).astype(np.int32)
        proto = np.repeat(np.repeat(small[y], reps, axis=1), reps, axis=2)
        x = proto + rstate.randn(*proto.shape).astype(np.float32) * noise
        return np.clip(x, 0.0, 1.0), y

    tx, ty = draw(num_train, rs)
    vx, vy = draw(num_test, np.random.RandomState(seed + 1))
    return {"train_x": tx, "train_y": ty, "test_x": vx, "test_y": vy}


def get_imagenet(data_dir: str | None, synthetic: bool = False,
                 **synth_kw) -> dict[str, np.ndarray]:
    """The synthetic set; a real ``data_dir`` raises: the readers (and
    their ``max_per_class`` bound) arrive with slice A5b-2."""
    if data_dir and not synthetic:
        raise NotImplementedError(
            f"reading ImageNet from {data_dir!r} arrives with slice A5b-2 "
            "of the port; omit --data_dir for the synthetic set")
    return synthetic_imagenet(**synth_kw)
