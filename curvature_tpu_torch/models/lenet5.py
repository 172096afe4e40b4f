"""LeNet-5 as the reference's bundled MNIST model.

Port of ``curvature_tpu/models/lenet5.py``: Conv(1->6, 5x5, pad 2), ReLU,
MaxPool 2x2, Conv(6->16, 5x5), ReLU, MaxPool 2x2, Flatten, Dense(400->120),
ReLU, Dense(120->84), ReLU, Dense(84->10), on NCHW [B, 1, 28, 28] input.
The tracked layers keep the JAX names (``conv1``, ``conv2``, ``fc1``,
``fc2``, ``fc3``), which key the factor files; fc1's 400 inputs are in
(c, h, w) order in both packages, so the bundled JAX-layout checkpoint
(``assets/lenet5_mnist.npz``, a copy of the JAX package's) loads through
``models.load_jax_variables``. A checkpoint of the reference's own
``nn.Sequential`` (``curvature/lenet5_mnist.pth``) names its layers by
position: ``TORCH_KEY_MAP`` carries them to these names
(``models.torch_convert``).
"""
from curvature_tpu_torch.nn import (
    Conv, Dense, Flatten, MaxPool, ReLU, Sequential,
)
from curvature_tpu_torch.utils.device import resolve_device

#: torch Sequential state-dict prefixes -> the layer names (JAX
#: lenet5.py:14)
TORCH_KEY_MAP = {"0": "conv1", "3": "conv2", "7": "fc1", "9": "fc2",
                 "11": "fc3"}


def lenet5(num_classes: int = 10, device=None, in_channels: int = 1,
           image_size: int = 28) -> Sequential:
    """Build on ``device`` (CUDA unless ``"cpu"`` is passed) for square
    ``[B, in_channels, image_size, image_size]`` inputs (JAX infers both at
    ``init``: 3 channels and 32² on synthetic data give fc1 16*6*6 = 576
    inputs)."""
    device = resolve_device(device)
    side = (image_size // 2 - 4) // 2
    return Sequential([
        Conv(in_channels, 6, 5, padding=2, name="conv1"),
        ReLU(),
        MaxPool(2, 2),
        Conv(6, 16, 5, name="conv2"),
        ReLU(),
        MaxPool(2, 2),
        Flatten(),
        Dense(16 * side * side, 120, name="fc1"),
        ReLU(),
        Dense(120, 84, name="fc2"),
        ReLU(),
        Dense(84, num_classes, name="fc3"),
    ]).to(device)
