"""Synthetic datasets of the paper's experiments (numpy generators)."""
from .synthetic import (SyntheticSpec, make_graded_classification,
                        make_graded_regression, make_sparse_classification,
                        make_sparse_regression, make_sparse_softmax)

__all__ = ["SyntheticSpec", "make_graded_classification",
           "make_graded_regression",
           "make_sparse_classification", "make_sparse_regression",
           "make_sparse_softmax"]
