"""The pipeline CLIs: ``training`` (SGD, Adam or the KFAC optimizer, SWAG
collection, the checkpoint), ``factors`` (estimate and save the curvature
factors), ``hyper`` (search the damping), ``evaluate`` (the deterministic
test, in-domain vs out-of-domain Bayesian eval with the sampled,
closed-form or linearized predictive, the FGSM sweep), ``loss_landscape``
(1-D and 2-D loss surfaces) and ``visualize`` (its tables), with the JAX
package's flags, artefact paths and npz layout. ``plot`` and the figures of
``visualize`` need matplotlib, which the port does not use: asking this
package for ``plot`` raises ``NotImplementedError``."""

_NOT_PORTED = ("plot",)


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"curvature_tpu_torch.pipelines.{name} is not ported: its "
            "figures need matplotlib (ROADMAP Queue 1 item 7)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
