"""Synthetic datasets of the paper's experiments (numpy generators)."""
from .synthetic import (SyntheticSpec, make_graded_regression,
                        make_sparse_regression)

__all__ = ["SyntheticSpec", "make_graded_regression", "make_sparse_regression"]
