from curvature_tpu_torch.eval import metrics
from curvature_tpu_torch.eval.evaluate import eval_bnn, eval_nn

__all__ = ["metrics", "eval_bnn", "eval_nn"]
