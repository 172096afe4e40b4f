"""The JAX package's pipelines (``factors``, ``evaluate``, ``hyper``,
``training``, ...) are not ported yet (ROADMAP Queue 1 item 7): any name
asked of this package raises ``NotImplementedError``."""


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        f"curvature_tpu_torch.pipelines.{name} is not ported yet "
        "(ROADMAP Queue 1 item 7)")
