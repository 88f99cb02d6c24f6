from repro_torch.utils.bridge import ParamLayout, from_jax_params, to_numpy

__all__ = ["ParamLayout", "from_jax_params", "to_numpy"]
