"""Inception Score and FID: the tower's scorers and weight readers."""
from .inception_score import (  # noqa: F401
    InceptionScorer, compute_inception_score,
    negative_log_posterior_probability)
from .fid import (  # noqa: F401
    FIDScorer, calculate_activation_statistics, calculate_frechet_distance)
