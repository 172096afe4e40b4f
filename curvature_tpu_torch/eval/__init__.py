from curvature_tpu_torch.eval import metrics
from curvature_tpu_torch.eval.attacks import eval_fgsm, eval_fgsm_bnn, fgsm
from curvature_tpu_torch.eval.evaluate import (
    eval_bnn, eval_nn, eval_nn_and_bnn,
)

__all__ = ["metrics", "eval_bnn", "eval_nn", "eval_nn_and_bnn", "fgsm",
           "eval_fgsm", "eval_fgsm_bnn"]
