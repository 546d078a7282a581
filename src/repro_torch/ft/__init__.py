"""Fault tolerance (paper §3.4 and the classical mechanisms).

A failed data shard turns an exact job into a sampled one: instead of
restarting, re-weight the survivors (``correct(·, p)``) and report the
result with a bootstrap error bound; restart from a checkpoint only if
the bound misses the target.  With it: checkpoint restart
(``checkpoint/``), elastic re-meshing, deadline-based straggler
mitigation (a straggler is a temporarily failed shard), deterministic
fault injection (``inject``) and the one FailurePolicy (``policy``) that
recovery, stragglers and elastic degradation all go through."""
from repro_torch.ft.recovery import (ShardLossReport, estimate_with_failures,
                                     failure_mask)
from repro_torch.ft.elastic import elastic_restore, mesh_for_devices
from repro_torch.ft.straggler import DeadlineReducer, StragglerReport
from repro_torch.ft.inject import (Fault, FaultCounters, FaultExhaustedError,
                                   FaultyStore, ResilientStore, RetryPolicy,
                                   bit_flip, enospc_after, torn_write)
from repro_torch.ft.policy import (CONTINUE, RESTART, ElasticReport,
                                   FailurePolicy, LagPolicy, ShardEvents,
                                   elastic_estimate)

__all__ = ["ShardLossReport", "estimate_with_failures", "failure_mask",
           "elastic_restore", "mesh_for_devices", "DeadlineReducer",
           "StragglerReport", "Fault", "FaultCounters",
           "FaultExhaustedError", "FaultyStore", "ResilientStore",
           "RetryPolicy", "bit_flip", "enospc_after", "torn_write",
           "CONTINUE", "RESTART", "ElasticReport",
           "FailurePolicy", "LagPolicy", "ShardEvents", "elastic_estimate"]
