"""Synthetic datasets made with numpy generators."""
from repro_torch.data.synthetic import (covtype_like, gaussian_mixture,
                                        gaussian_mixture_multiclass,
                                        train_test_split, webspam_like)

__all__ = ["covtype_like", "gaussian_mixture", "gaussian_mixture_multiclass",
           "train_test_split", "webspam_like"]
