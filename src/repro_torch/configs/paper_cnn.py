"""The paper's own model scale: 3-layer CNN (MNIST) / compact CNN (CIFAR),
per Sec V-A. Used by the federated simulation."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CNNConfig:
    name: str = "paper-cnn"
    image_size: int = 32
    channels: int = 3
    n_classes: int = 10
    widths: Tuple[int, ...] = (32, 64, 64)
    hidden: int = 128


def mnist_cnn() -> CNNConfig:
    return CNNConfig(name="mnist-cnn", image_size=28, channels=1,
                     n_classes=10, widths=(16, 32, 32), hidden=64)


def cifar10_cnn() -> CNNConfig:
    return CNNConfig(name="cifar10-cnn")


def cifar100_cnn() -> CNNConfig:
    return CNNConfig(name="cifar100-cnn", n_classes=100)
