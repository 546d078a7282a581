"""EARL core in PyTorch: statistics, accuracy, the bootstrap engines
(materialized and matrix-free), delta maintenance, SSABE, the session
driver and the crash-safe streaming bootstrap."""
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
                                        weights_for)
from repro_torch.core.delta import (MultinomialDeltaBootstrap, PoissonDelta,
                                    Sketch, optimal_y, p_shared,
                                    poisson_delta_extend, poisson_delta_init,
                                    poisson_delta_result,
                                    shared_base_bootstrap, work_saved)
from repro_torch.core.reduce_api import (Count, GroupedStatistic,
                                         HistogramState, KMeansState,
                                         KMeansStep, Mean, Median,
                                         MomentState, Quantile, Statistic,
                                         StatisticGroup, Std, Sum, Var,
                                         kmeans_fit)
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
    "poisson_weights", "seed_from_key", "weights_for",
    "MultinomialDeltaBootstrap", "PoissonDelta", "Sketch", "optimal_y",
    "p_shared", "poisson_delta_extend", "poisson_delta_init",
    "poisson_delta_result", "shared_base_bootstrap", "work_saved",
    "Count", "GroupedStatistic", "HistogramState", "KMeansState",
    "KMeansStep", "Mean", "Median", "MomentState", "Quantile", "Statistic",
    "StatisticGroup", "Std", "Sum", "Var", "kmeans_fit",
    "EarlSession", "EarlyResult", "SSABEResult", "ssabe",
    "StreamingBootstrapResult", "StreamReport", "bootstrap_streaming",
]
