"""``posterior_s``: seconds of ``KFAC.invert`` at the configuration's
damping and the ``samples`` draws of ``ensemble_params`` in the eval's
set-up, between two synchronizes."""


def read(rec):
    return rec.get("posterior_s")
