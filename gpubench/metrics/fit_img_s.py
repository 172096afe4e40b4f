"""``fit_img_s``: images through the ``fit`` generator's steps, all the
window's work over all its time."""
from gpubench.readers import rate


def read(rec):
    return rate(rec, "fit", "img")
