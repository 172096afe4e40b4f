"""Hand-written CUDA kernels (sources in ``csrc/``, built by ``build``).

Import the entry points from their modules, ``ops.cuda.patch_gram`` and
``ops.cuda.sym_gram``: the package re-exports nothing, since the functions
``patch_gram`` and ``sym_gram`` would hide the modules of the same names.
What the wrappers share is in ``ops.cuda.launch``.
"""
