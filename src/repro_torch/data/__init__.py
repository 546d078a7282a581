"""Data substrate: sharded store, samplers, synthetic data."""
from repro_torch.data.sampler import PermutationSampler, PreMapSampler
from repro_torch.data.store import ReadStats, ShardedStore
from repro_torch.data.synthetic import synthetic_numeric

__all__ = ["PermutationSampler", "PreMapSampler", "ReadStats",
           "ShardedStore", "synthetic_numeric"]
