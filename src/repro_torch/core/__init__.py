"""DC-SVM core: kernels, tasks, solvers, kernel k-means, the kernel
operator, Algorithm 1, one-vs-all and prediction.  Exports the names of
the reference's ``repro.core``, ``resolve_use_pallas`` as
``resolve_use_kernels``."""
from repro_torch.core import bounds, colcache
from repro_torch.core.dcsvm import (DCSVMConfig, DCSVMModel, fit,
                                    objective_value)
from repro_torch.core.gramop import (GramOperator, fits_budget,
                                     solve_box_qp_spill)
from repro_torch.core.kernels import (DEFAULT_GRAM_BUDGET, Kernel,
                                      auto_num_chunks, gram, gram_matvec,
                                      offdiag_mass, resolve_use_kernels,
                                      sqdist)
from repro_torch.core.kkmeans import (KKMeansModel, Partition, assign_points,
                                      balanced_assign, kernel_kmeans, route,
                                      two_step_kernel_kmeans)
from repro_torch.core.multiclass import (MulticlassModel, fit_ova,
                                         labels_to_ova, ova_cost_vectors)
from repro_torch.core.predict import (accuracy, accuracy_multiclass,
                                      bucketed_cluster_scores, decision_bcm,
                                      decision_bcm_ova, decision_early,
                                      decision_early_ova, decision_exact,
                                      decision_exact_ova, early_capacity, f1,
                                      mae, mse, precision, predict_bcm,
                                      predict_bcm_ova, predict_early,
                                      predict_early_ova, predict_exact,
                                      predict_exact_ova, recall)
from repro_torch.core.solver import (SolveResult, equality_interval,
                                     equality_interval_grouped, equality_rho,
                                     equality_rho_grouped, kkt_residual,
                                     kkt_residual_eq, objective, proj_grad,
                                     project_box_equality, solve_box_qp,
                                     solve_box_qp_block, solve_box_qp_matvec,
                                     solve_eq_qp, solve_eq_qp_block,
                                     solve_eq_qp_matvec, solve_eq_qp_shrink,
                                     solve_with_shrinking)
from repro_torch.core.tasks import (CSVC, EpsilonSVR, NuSVC, OneClassSVM,
                                    Task, TaskDual, WeightedCSVC,
                                    resolve_task)

__all__ = ["CSVC", "DCSVMConfig", "DCSVMModel", "DEFAULT_GRAM_BUDGET",
           "EpsilonSVR", "GramOperator", "KKMeansModel", "Kernel",
           "MulticlassModel", "NuSVC", "OneClassSVM", "Partition",
           "SolveResult", "Task", "TaskDual", "WeightedCSVC", "accuracy",
           "accuracy_multiclass", "assign_points", "auto_num_chunks",
           "balanced_assign", "bounds", "bucketed_cluster_scores",
           "colcache", "decision_bcm", "decision_bcm_ova", "decision_early",
           "decision_early_ova", "decision_exact", "decision_exact_ova",
           "early_capacity", "equality_interval", "equality_interval_grouped",
           "equality_rho", "equality_rho_grouped", "f1", "fit", "fit_ova",
           "fits_budget", "gram", "gram_matvec", "kernel_kmeans",
           "kkt_residual", "kkt_residual_eq", "labels_to_ova", "mae", "mse",
           "objective", "objective_value", "offdiag_mass",
           "ova_cost_vectors", "precision", "predict_bcm", "predict_bcm_ova",
           "predict_early", "predict_early_ova", "predict_exact",
           "predict_exact_ova", "proj_grad", "project_box_equality",
           "recall", "resolve_task", "resolve_use_kernels", "route",
           "solve_box_qp", "solve_box_qp_block", "solve_box_qp_matvec",
           "solve_box_qp_spill", "solve_eq_qp", "solve_eq_qp_block",
           "solve_eq_qp_matvec", "solve_eq_qp_shrink", "solve_with_shrinking",
           "sqdist", "two_step_kernel_kmeans"]
