# one module per ported architecture (registry side effects)
from repro_torch.configs import (chatglm3_6b, deepseek_v3_671b,  # noqa: F401
                                 falcon_mamba_7b, granite_moe_3b_a800m,
                                 minicpm3_4b, musicgen_large, qwen2_vl_2b,
                                 smollm_135m, starcoder2_15b, zamba2_7b)
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      PFLConfig, ShapeConfig, SSMConfig,
                                      TrainConfig, WirelessConfig,
                                      get_config, list_archs)
from repro_torch.configs.paper_cnn import (CNNConfig, cifar10_cnn,
                                           cifar100_cnn, mnist_cnn)
from repro_torch.configs.shapes import SHAPES, get_shape

__all__ = ["CNNConfig", "MLAConfig", "ModelConfig", "MoEConfig", "PFLConfig",
           "SHAPES", "SSMConfig", "ShapeConfig", "TrainConfig",
           "WirelessConfig", "cifar10_cnn", "cifar100_cnn", "get_config",
           "get_shape", "list_archs", "mnist_cnn"]
