"""Character-level CNN baseline (flax) — Zhang et al. 2015 variant.

Architecture parity with the reference's PyTorch CharacterLevelCNN
(results/neural_nets/models.py:80-172): three conv1d+relu stages (7/7/3
kernels, 256 channels, maxpool 3 after the first two), then
1024-1024-classes MLP with dropout. Input is a one-hot [B, L, A] tensor;
all shapes static so the whole step jits into one device program.
"""

from __future__ import annotations


import flax.linen as nn
import jax.numpy as jnp


class CharCNN(nn.Module):
    n_classes: int = 2
    channels: int = 256
    dropout_input: float = 0.1
    dropout_fc: float = 0.5

    @nn.compact
    def __call__(self, x: jnp.ndarray, *, train: bool = False) -> jnp.ndarray:
        # x: [B, L, A] one-hot
        x = nn.Dropout(self.dropout_input, deterministic=not train)(x)
        x = nn.Conv(self.channels, kernel_size=(7,), padding="VALID")(x)
        x = nn.relu(x)
        x = nn.max_pool(x, window_shape=(3,), strides=(3,))
        x = nn.Conv(self.channels, kernel_size=(7,), padding="VALID")(x)
        x = nn.relu(x)
        x = nn.max_pool(x, window_shape=(3,), strides=(3,))
        x = nn.Conv(self.channels, kernel_size=(3,), padding="VALID")(x)
        x = nn.relu(x)
        x = x.reshape(x.shape[0], -1)
        x = nn.Dense(1024)(x)
        x = nn.relu(x)
        x = nn.Dropout(self.dropout_fc, deterministic=not train)(x)
        x = nn.Dense(1024)(x)
        x = nn.relu(x)
        x = nn.Dropout(self.dropout_fc, deterministic=not train)(x)
        return nn.Dense(self.n_classes)(x)
