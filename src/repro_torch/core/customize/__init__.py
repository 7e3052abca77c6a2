"""Accelerator customization (``repro.core.customize``, §VI): Bayesian-ridge
resource predictors and Algorithm 1's resource DP, numpy only."""
from .allocate import Allocation, Predictors, allocate, sample_space, train_predictors
from .bayes import BayesianRidge
from .resource_model import ULTRA96, StageConfig, stage_features, stage_resources

__all__ = [
    "Allocation",
    "Predictors",
    "allocate",
    "sample_space",
    "train_predictors",
    "BayesianRidge",
    "ULTRA96",
    "StageConfig",
    "stage_features",
    "stage_resources",
]
