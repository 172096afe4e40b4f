from curvature_tpu_torch.eval import metrics
from curvature_tpu_torch.eval.attacks import eval_fgsm, eval_fgsm_bnn, fgsm
from curvature_tpu_torch.eval.evaluate import (
    STATS_COLUMNS, eval_bnn, eval_bnn_stats, eval_nn, eval_nn_and_bnn,
    eval_nn_stats,
)

__all__ = ["metrics", "STATS_COLUMNS", "eval_bnn", "eval_bnn_stats",
           "eval_nn", "eval_nn_and_bnn", "eval_nn_stats", "fgsm",
           "eval_fgsm", "eval_fgsm_bnn"]
