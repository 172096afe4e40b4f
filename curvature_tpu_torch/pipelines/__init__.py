"""The pipeline CLIs: ``training`` (SGD, Adam or the KFAC optimizer, SWAG
collection, the checkpoint), ``factors`` (estimate and save the curvature
factors), ``hyper`` (search the damping), ``evaluate`` (the deterministic
test, in-domain vs out-of-domain Bayesian eval with the sampled,
closed-form or linearized predictive, the FGSM sweep), ``loss_landscape``
(1-D and 2-D loss surfaces) and ``visualize`` (its figures and tables),
with the JAX package's flags, artefact paths and npz layout. ``plot``
draws the figures (``--plot`` in the CLIs) on the port's own figure model
and its PDF, SVG and PNG writers (``utils/figure.py``, ``utils/pdf.py``,
``utils/svg.py``, ``utils/png.py``). The package exports JAX's
``build_model``, ``build_data`` and ``input_shape``."""
from curvature_tpu_torch.pipelines.common import (
    build_data, build_model, input_shape,
)

__all__ = ["build_model", "build_data", "input_shape"]
