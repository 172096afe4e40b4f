"""Runnable examples of the port (``curvature_tpu/examples``' scripts):
each runs as ``python -m curvature_tpu_torch.examples.<name>``, on the
CUDA device unless ``--platform cpu`` is given, and has a ``main(argv)``
that returns its results. Importing one runs nothing."""
