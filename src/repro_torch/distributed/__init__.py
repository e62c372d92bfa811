from .sharding import (batch_pspec, cache_shardings, data_axes, distribute,
                       logical_pspec, param_shardings, pspec_to_sharding)

__all__ = ["batch_pspec", "cache_shardings", "data_axes", "distribute",
           "logical_pspec", "param_shardings", "pspec_to_sharding"]
