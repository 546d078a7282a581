"""The paper's own workload: EARL analytics jobs (mean / median / K-Means)
over a synthetic sharded store, the configuration behind the JAX package's
benchmarks/fig*, field for field the JAX package's
``repro/configs/earl_analytics.py``.

Not a neural architecture, so ``get_config`` does not list it: EARL is
infrastructure evaluated on analytics jobs."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class AnalyticsConfig:
    name: str = "earl-analytics"
    N: int = 2_000_000             # population rows
    split_size: int = 65_536       # HDFS-split analogue
    sigma: float = 0.05            # paper §6: 5% normalized error
    tau: float = 0.01              # error-stability threshold
    p_pilot: float = 0.01          # paper §3.2: p = 0.01 pilot
    l: int = 5                     # paper §3.2: l = 5 nested subsamples
    kmeans_k: int = 5
    kmeans_iters: int = 8
    engine: str = "poisson"        # distributed default (DESIGN.md §7.1)


CONFIG = AnalyticsConfig()
