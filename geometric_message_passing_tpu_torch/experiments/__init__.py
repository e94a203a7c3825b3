"""Experiment harness of the port: batch inference, regression and
classification training with their repeat protocols, and the benchmarks."""

from .train import (  # noqa: F401
    fit_classification,
    fit_regression,
    run_experiment,
    run_experiment_reg,
)
