"""EARL core in PyTorch: statistics, accuracy, the bootstrap engines
(materialized and matrix-free, on one device or split over a mesh), delta
maintenance, SSABE, the session driver with checkpoint and resume, the
distributed estimator, the crash-safe streaming bootstrap and the windows
a live session folds."""
from repro_torch.core.accuracy import (AccuracyReport, GroupAccuracyReport,
                                       KeyedAccuracyReport,
                                       coefficient_of_variation,
                                       percentile_ci, relative_halfwidth,
                                       report_for, standard_error,
                                       theoretical_num_bootstraps,
                                       theoretical_sample_size)
from repro_torch.core.bootstrap import (BootstrapResult, bootstrap,
                                        bootstrap_chunked, bootstrap_thetas,
                                        fused_resample_states,
                                        multinomial_counts, offset_seed,
                                        poisson_weights, seed_from_key,
                                        sharded_fused_states, weights_for)
from repro_torch.core.delta import (MultinomialDeltaBootstrap, PoissonDelta,
                                    Sketch, optimal_y, p_shared,
                                    poisson_delta_extend, poisson_delta_init,
                                    poisson_delta_result,
                                    shared_base_bootstrap, work_saved)
from repro_torch.core.distributed import (DistributedEarl,
                                          build_bootstrap_step,
                                          shard_values)
from repro_torch.core.reduce_api import (Count, GroupedStatistic,
                                         HistogramState, KMeansState,
                                         KMeansStep, Mean, MeanLoss, Median,
                                         MomentState, Quantile,
                                         SlidingWindow, Statistic,
                                         StatisticGroup, Std, Sum,
                                         TumblingWindow, Var, Window,
                                         bind_params, kmeans_fit)
from repro_torch.core.session import EarlSession, EarlyResult
from repro_torch.core.ssabe import SSABEResult, ssabe
from repro_torch.core.streaming import (StreamingBootstrapResult,
                                        StreamReport, bootstrap_streaming)

__all__ = [
    "AccuracyReport", "GroupAccuracyReport", "KeyedAccuracyReport",
    "coefficient_of_variation", "percentile_ci", "relative_halfwidth",
    "report_for", "standard_error", "theoretical_num_bootstraps",
    "theoretical_sample_size",
    "BootstrapResult", "bootstrap", "bootstrap_chunked", "bootstrap_thetas",
    "fused_resample_states", "multinomial_counts", "offset_seed",
    "poisson_weights", "seed_from_key", "sharded_fused_states",
    "weights_for",
    "MultinomialDeltaBootstrap", "PoissonDelta", "Sketch", "optimal_y",
    "p_shared", "poisson_delta_extend", "poisson_delta_init",
    "poisson_delta_result", "shared_base_bootstrap", "work_saved",
    "DistributedEarl", "build_bootstrap_step", "shard_values",
    "Count", "GroupedStatistic", "HistogramState", "KMeansState",
    "KMeansStep", "Mean", "MeanLoss", "Median", "MomentState", "Quantile",
    "SlidingWindow", "Statistic", "StatisticGroup", "Std", "Sum",
    "TumblingWindow", "Var", "Window", "bind_params", "kmeans_fit",
    "EarlSession", "EarlyResult", "SSABEResult", "ssabe",
    "StreamingBootstrapResult", "StreamReport", "bootstrap_streaming",
]
