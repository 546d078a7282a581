"""Data substrate: sharded store, samplers, synthetic data, and the
training and earl_eval pipelines."""
from repro_torch.data.pipeline import (EvalSamplePipeline, PipelineState,
                                       TokenBatchPipeline)
from repro_torch.data.sampler import (PermutationSampler, PostMapSampler,
                                      PreMapSampler, StratifiedSampler)
from repro_torch.data.store import ReadStats, ShardedStore
from repro_torch.data.synthetic import (synthetic_clusters,
                                        synthetic_numeric, synthetic_tokens)

__all__ = ["EvalSamplePipeline", "PipelineState", "TokenBatchPipeline",
           "PermutationSampler", "PostMapSampler", "PreMapSampler",
           "ReadStats",
           "ShardedStore", "StratifiedSampler", "synthetic_clusters",
           "synthetic_numeric", "synthetic_tokens"]
