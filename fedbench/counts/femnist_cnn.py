"""Model FLOPs of the paper's FEMNIST CNN (conv 3x3 1->32, conv 3x3
32->64, 2x2 max-pool, dense 9216->128, dense 128->62), per sample.

A product of (m x k) by (k x n) is 2·m·k·n FLOPs. The backward pass takes
the gradient of every weight (as much as the forward product) and of
every layer's input but the first convolution's (the images need none).
ReLU, pooling, biases, the loss and the quantizer are not counted.
"""

from __future__ import annotations


def forward_flops(c: dict) -> dict:
    """FLOPs of each product of one sample's forward pass."""
    h1 = c["image_hw"] - c["kernel"] + 1
    h2 = h1 - c["kernel"] + 1
    k2 = c["kernel"] * c["kernel"]
    return {
        "conv1": 2 * h1 * h1 * c["conv1_channels"] * k2 * c["in_channels"],
        "conv2": 2 * h2 * h2 * c["conv2_channels"] * k2
        * c["conv1_channels"],
        "dense1": 2 * c["cut_dim"] * c["hidden"],
        "dense2": 2 * c["hidden"] * c["num_classes"],
    }


def train_flops_per_sample(c: dict) -> int:
    """Forward and backward FLOPs of one sample."""
    f = forward_flops(c)
    return 3 * sum(f.values()) - f["conv1"]
