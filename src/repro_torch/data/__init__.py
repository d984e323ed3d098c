from .synthetic import DataConfig, DataStream, batch_at, compute_cost_proxy, microbatches_at

__all__ = ["DataConfig", "DataStream", "batch_at", "compute_cost_proxy", "microbatches_at"]
