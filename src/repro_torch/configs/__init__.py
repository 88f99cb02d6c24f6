from repro_torch.configs.base import PFLConfig, WirelessConfig
from repro_torch.configs.paper_cnn import CNNConfig, cifar10_cnn, mnist_cnn

__all__ = ["CNNConfig", "PFLConfig", "WirelessConfig", "cifar10_cnn",
           "mnist_cnn"]
