"""DC-SVM core: kernels, tasks, solvers, kernel k-means, the kernel
operator, Algorithm 1 and prediction."""
from repro_torch.core.dcsvm import (DCSVMConfig, DCSVMModel, fit,
                                    objective_value)
from repro_torch.core.kernels import Kernel, gram, gram_matvec
from repro_torch.core.predict import (accuracy, decision_early,
                                      decision_exact, predict_early,
                                      predict_exact)
from repro_torch.core.tasks import CSVC

__all__ = ["CSVC", "DCSVMConfig", "DCSVMModel", "Kernel", "accuracy",
           "decision_early", "decision_exact", "fit", "gram", "gram_matvec",
           "objective_value", "predict_early", "predict_exact"]
