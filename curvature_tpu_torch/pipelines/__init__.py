"""The pipeline CLIs: ``factors`` (estimate and save the curvature
factors), ``hyper`` (search the damping) and ``evaluate`` (the
deterministic test, in-domain vs out-of-domain Bayesian eval with the
sampled, closed-form or linearized predictive, the FGSM sweep), with the
JAX package's flags, artefact paths and npz layout. The other pipelines
(``training``, ``loss_landscape``, ``visualize``, ``plot``) are not
ported yet (ROADMAP Queue 1 item 7): asking this package for one raises
``NotImplementedError``."""

_NOT_PORTED = ("training", "loss_landscape", "visualize", "plot")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"curvature_tpu_torch.pipelines.{name} is not ported yet "
            "(ROADMAP Queue 1 item 7)")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
