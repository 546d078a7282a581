"""EARL core in PyTorch: statistics, accuracy, the matrix-free bootstrap,
delta maintenance, SSABE and the session driver."""
from repro_torch.core.accuracy import (AccuracyReport, GroupAccuracyReport,
                                       KeyedAccuracyReport,
                                       coefficient_of_variation,
                                       percentile_ci, relative_halfwidth,
                                       report_for, standard_error,
                                       theoretical_num_bootstraps,
                                       theoretical_sample_size)
from repro_torch.core.bootstrap import (BootstrapResult, bootstrap,
                                        fused_resample_states, offset_seed,
                                        seed_from_key)
from repro_torch.core.delta import (PoissonDelta, poisson_delta_extend,
                                    poisson_delta_init, poisson_delta_result)
from repro_torch.core.reduce_api import (Count, GroupedStatistic,
                                         HistogramState, KMeansState,
                                         KMeansStep, Mean, Median,
                                         MomentState, Quantile, Statistic,
                                         StatisticGroup, Std, Sum, Var,
                                         kmeans_fit)
from repro_torch.core.session import EarlSession, EarlyResult
from repro_torch.core.ssabe import SSABEResult, ssabe

__all__ = [
    "AccuracyReport", "GroupAccuracyReport", "KeyedAccuracyReport",
    "coefficient_of_variation", "percentile_ci", "relative_halfwidth",
    "report_for", "standard_error", "theoretical_num_bootstraps",
    "theoretical_sample_size",
    "BootstrapResult", "bootstrap", "fused_resample_states", "offset_seed",
    "seed_from_key",
    "PoissonDelta", "poisson_delta_extend", "poisson_delta_init",
    "poisson_delta_result",
    "Count", "GroupedStatistic", "HistogramState", "KMeansState",
    "KMeansStep", "Mean", "Median", "MomentState", "Quantile", "Statistic",
    "StatisticGroup", "Std", "Sum", "Var", "kmeans_fit",
    "EarlSession", "EarlyResult", "SSABEResult", "ssabe",
]
