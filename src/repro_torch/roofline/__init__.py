from .analysis import (HW, CostMode, collective_bytes_from_log, floor_terms,
                       model_flops, roofline_terms)

__all__ = ["HW", "CostMode", "collective_bytes_from_log", "floor_terms",
           "model_flops", "roofline_terms"]
