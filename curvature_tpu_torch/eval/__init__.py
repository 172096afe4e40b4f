from curvature_tpu_torch.eval import metrics
from curvature_tpu_torch.eval.metrics import (
    accuracy, auroc, binned_kl_distance, calibration_curve, confidence,
    expected_calibration_error, gaussian_nll, get_eigenvalues,
    linear_interpolation, negative_log_likelihood, predictive_entropy, rmse,
)
from curvature_tpu_torch.eval.attacks import (
    eval_fgsm, eval_fgsm_bnn, fgsm, make_fgsm_fn,
)
from curvature_tpu_torch.eval.evaluate import (
    STATS_COLUMNS, eval_bnn, eval_bnn_stats, eval_nn, eval_nn_and_bnn,
    eval_nn_stats, make_ensemble_fn, make_forward_fn,
)
from curvature_tpu_torch.eval.predictive import (
    eval_bnn_closed_form, eval_bnn_linearized, eval_bnn_regression,
    laplace_bridge, make_linearized_ensemble_fn, make_logit_ensemble_fn,
    probit_mean_field,
)
from curvature_tpu_torch.eval.predictor import BayesianPredictor, Prediction
from curvature_tpu_torch.eval.marglik import (
    dataset_map_nll, log_marginal_likelihood,
)
from curvature_tpu_torch.eval.fidelity import fidelity_report
from curvature_tpu_torch.eval.influence import (
    influence_scores, loss_grad_matrix, per_example_grad_matrix,
    self_influence,
)
from curvature_tpu_torch.eval.calibrate import (
    eval_nn_temperature, fit_temperature, temperature_scale,
)

__all__ = ["metrics", "accuracy", "confidence", "negative_log_likelihood",
           "predictive_entropy", "expected_calibration_error",
           "calibration_curve", "binned_kl_distance",
           "linear_interpolation", "get_eigenvalues", "auroc", "rmse",
           "gaussian_nll", "STATS_COLUMNS", "eval_bnn", "eval_bnn_stats",
           "eval_nn", "eval_nn_and_bnn", "eval_nn_stats", "make_forward_fn",
           "make_ensemble_fn", "fgsm",
           "make_fgsm_fn", "eval_fgsm", "eval_fgsm_bnn",
           "BayesianPredictor", "Prediction",
           "probit_mean_field", "laplace_bridge", "eval_bnn_closed_form",
           "eval_bnn_linearized", "make_linearized_ensemble_fn",
           "make_logit_ensemble_fn", "eval_bnn_regression",
           "dataset_map_nll", "log_marginal_likelihood",
           "fit_temperature", "temperature_scale", "eval_nn_temperature",
           "fidelity_report", "influence_scores", "loss_grad_matrix",
           "per_example_grad_matrix", "self_influence"]
