"""DC-SVM core: kernels, tasks, solvers, kernel k-means, the kernel
operator, Algorithm 1, one-vs-all and prediction."""
from repro_torch.core.dcsvm import (DCSVMConfig, DCSVMModel, fit,
                                    objective_value)
from repro_torch.core.kernels import Kernel, gram, gram_matvec
from repro_torch.core.multiclass import (MulticlassModel, fit_ova,
                                         labels_to_ova, ova_cost_vectors)
from repro_torch.core.predict import (accuracy, accuracy_multiclass,
                                      decision_bcm, decision_bcm_ova,
                                      decision_early, decision_early_ova,
                                      decision_exact, decision_exact_ova, f1,
                                      mae, mse, precision, predict_bcm,
                                      predict_bcm_ova, predict_early,
                                      predict_early_ova, predict_exact,
                                      predict_exact_ova, recall)
from repro_torch.core.tasks import (CSVC, EpsilonSVR, NuSVC, OneClassSVM,
                                    Task, WeightedCSVC)

__all__ = ["CSVC", "DCSVMConfig", "DCSVMModel", "EpsilonSVR", "Kernel",
           "MulticlassModel", "NuSVC", "OneClassSVM", "Task", "WeightedCSVC",
           "accuracy", "accuracy_multiclass", "decision_bcm",
           "decision_bcm_ova", "decision_early", "decision_early_ova",
           "decision_exact", "decision_exact_ova", "f1", "fit", "fit_ova",
           "gram", "gram_matvec", "labels_to_ova", "mae", "mse",
           "objective_value", "ova_cost_vectors", "precision", "predict_bcm",
           "predict_bcm_ova", "predict_early", "predict_early_ova",
           "predict_exact", "predict_exact_ova", "recall"]
