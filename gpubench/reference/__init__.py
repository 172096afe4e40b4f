"""The benchmark's plain reference: the models, the KFAC factors, the
damped invert, the sample and the ensemble's mean softmax in plain PyTorch
(``torch`` alone, float32, no kernel of the measured program).

Every module here imports ``torch`` and the standard library and nothing
else: not the measured package, not JAX. It is a frozen copy, written from
the published descriptions of the models and of KFAC, and it takes from
the benchmark only the raw inputs (seeded weights, batches, labels and
noise) that the program is given too.
"""
