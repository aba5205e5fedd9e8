"""Synthetic datasets made with numpy generators."""
from repro_torch.data.synthetic import (checkerboard, covtype_like, friedman1,
                                        gaussian_mixture,
                                        gaussian_mixture_imbalanced,
                                        gaussian_mixture_multiclass,
                                        gaussian_with_outliers, sinc1d,
                                        stratified_split, train_test_split,
                                        two_spirals, webspam_like)

__all__ = ["checkerboard", "covtype_like", "friedman1", "gaussian_mixture",
           "gaussian_mixture_imbalanced", "gaussian_mixture_multiclass",
           "gaussian_with_outliers", "sinc1d", "stratified_split",
           "train_test_split", "two_spirals", "webspam_like"]
