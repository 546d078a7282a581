"""Fault tolerance (paper §3.4): deterministic fault injection, resilient
counted reads and the FailurePolicy the streaming driver reads through.

A failed data shard turns an exact job into a sampled one: instead of
restarting, re-weight the survivors (``correct(·, p)``) and report the
result with a bootstrap error bound; restart from a checkpoint only if
the bound misses the target."""
from repro_torch.ft.inject import (Fault, FaultCounters, FaultExhaustedError,
                                   FaultyStore, ResilientStore, RetryPolicy,
                                   bit_flip, enospc_after, torn_write)
from repro_torch.ft.policy import (CONTINUE, RESTART, FailurePolicy,
                                   LagPolicy, ShardEvents)

__all__ = ["Fault", "FaultCounters", "FaultExhaustedError", "FaultyStore",
           "ResilientStore", "RetryPolicy", "bit_flip", "enospc_after",
           "torn_write", "CONTINUE", "RESTART", "FailurePolicy", "LagPolicy",
           "ShardEvents"]
