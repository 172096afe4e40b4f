"""``setup_s``: seconds from the process's start to the first timed step:
imports, building kernels where none are built, the seeded weights and
inputs, the program's set-up and warm-up."""


def read(rec):
    return rec["setup_s"]
