"""Port parity: the patch-Gram entry points of ``curvature_tpu_torch``
against the JAX Pallas functions (interpret mode), and the dispatch
policy against the JAX one.

On the CPU the port's wrappers compute their plain PyTorch versions; the
CUDA kernels are held against those plain versions by the ``cuda``-marked
test below, which skips where there is no card.
"""
import importlib

import numpy as np
import pytest
import torch

from curvature_tpu_torch.ops.cuda import patch_gram as tpg

try:
    import jax.numpy as jnp
    # the package re-exports a function named patch_gram over the module
    jpg = importlib.import_module("curvature_tpu.ops.pallas.patch_gram")
except ImportError:
    # the card's machine has no JAX: only the cuda-marked tests run there
    # (python -m pytest tests/test_torch_patch_gram.py --noconftest -m cuda)
    jnp = jpg = None

torch.set_num_threads(1)

#: tests/test_pallas_kernels.py:41-45 (stride 1) and :55-62 (stride 2)
V2_CASES = [
    ((2, 8, 8, 4), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ((3, 10, 6, 8), (3, 3), ((0, 0), (0, 0)), (1, 1)),
    ((2, 7, 7, 4), (5, 5), ((2, 2), (2, 2)), (1, 1)),
    ((2, 8, 8, 4), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ((3, 9, 9, 8), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ((2, 10, 6, 8), (3, 3), ((0, 0), (0, 0)), (2, 2)),
    ((2, 12, 12, 4), (5, 5), ((2, 2), (2, 2)), (2, 2)),
    ((2, 8, 8, 4), (3, 3), "SAME", (2, 2)),
    ((2, 7, 9, 4), (3, 3), "SAME", (2, 2)),
]

#: tests/test_pallas_kernels.py:94-101
TILED_CASES = [
    ((2, 14, 14, 256), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ((2, 7, 7, 512), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ((2, 16, 16, 64), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ((2, 12, 12, 128), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ((2, 9, 9, 96), (3, 3), "SAME", (1, 1)),
    ((1, 10, 10, 32), (5, 5), ((2, 2), (2, 2)), (1, 1)),
]


def _assert_gram_close(got, want):
    """The JAX tests' bar: rtol 1e-4, atol 1e-4 * max|G| (f32 sums over
    up to a few thousand tokens in another order)."""
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("shape,ks,pad,strides", V2_CASES)
def test_patch_gram_v2_plain_matches_jax(shape, ks, pad, strides):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jpg.patch_gram_v2(jnp.asarray(x), ks, pad, strides,
                                        interpret=True))
    got = tpg.patch_gram_v2(torch.from_numpy(x), ks, pad, strides).numpy()
    _assert_gram_close(got, want)


@pytest.mark.parametrize("shape,ks,pad,strides", TILED_CASES)
def test_patch_gram_tiled_plain_matches_jax(shape, ks, pad, strides):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jpg.patch_gram_tiled(jnp.asarray(x), ks, pad, strides,
                                           interpret=True))
    got = tpg.patch_gram_tiled(torch.from_numpy(x), ks, pad,
                               strides).numpy()
    _assert_gram_close(got, want)


def test_cpu_wrappers_do_not_count_launches():
    """The launch counters count kernel launches only; the plain version
    on a CPU tensor is not one."""
    before = (tpg.patch_gram_tiled.launches, tpg.patch_gram_v2.launches)
    x = torch.zeros(1, 8, 8, 64)
    tpg.patch_gram_tiled(x, (3, 3), ((1, 1), (1, 1)))
    tpg.patch_gram_v2(x, (3, 3), ((1, 1), (1, 1)), (2, 2))
    assert (tpg.patch_gram_tiled.launches,
            tpg.patch_gram_v2.launches) == before


def test_tiled_rejects_infeasible_plan_like_jax():
    x = torch.zeros(1, 8, 8, 16)                     # C < 32
    with pytest.raises(ValueError):
        tpg.patch_gram_tiled(x, (3, 3), ((1, 1), (1, 1)))
    with pytest.raises(ValueError):
        jpg.patch_gram_tiled(jnp.zeros((1, 8, 8, 16)), (3, 3),
                             ((1, 1), (1, 1)), interpret=True)


def _resnet50_conv_shapes(batch=16, size=224):
    """(C, kernel, stride, H) of every ResNet-50 conv at ``size``."""
    shapes = [(3, 7, 2, size)]
    h = -(-size // 2) // 2                           # stem conv + maxpool
    c_in = 64
    for planes, n in zip((64, 128, 256, 512), (3, 4, 6, 3)):
        for i in range(n):
            s = 2 if (i == 0 and planes != 64) else 1
            shapes += [(c_in, 1, 1, h), (planes, 3, s, h),
                       (planes, 1, 1, -(-h // s))]
            if i == 0:
                shapes.append((c_in, 1, s, h))
            h, c_in = -(-h // s), planes * 4
    return [(c, (k, k), (s, s), hh, hh, batch) for c, k, s, hh in shapes]


@pytest.mark.parametrize("itemsize", [4, 2])
def test_dispatch_policy_matches_jax(itemsize):
    shapes = _resnet50_conv_shapes()
    assert len(shapes) == 53
    routes = []
    for c, ks, st, h, w, b in shapes:
        want = jpg.select_patch_gram(c, ks, st, h, w, b, itemsize)
        assert tpg.select_patch_gram(c, ks, st, h, w, b, itemsize) == want
        assert tpg.tiled_plan(c, ks, st, h, w, b, itemsize) \
            == jpg.tiled_plan(c, ks, st, h, w, b, itemsize)
        assert tpg.patch_gram_v2_supported(c, ks, st, h, w, itemsize) \
            == jpg.patch_gram_v2_supported(c, ks, st, h, w, itemsize)
        routes.append(want)
    if itemsize == 4:
        # layer1.{0,1,2}.conv2 -> tiled, layer2.0.conv2 -> v2 (the two
        # launches of the main path), and the stride-1 C=128 convs
        assert routes.count("tiled") == 3 + 3
        assert routes.count("v2") == 1


@pytest.mark.cuda
@pytest.mark.parametrize("entry,shape,ks,pad,strides", [
    ("tiled", (16, 56, 56, 64), (3, 3), ((1, 1), (1, 1)), (1, 1)),
    ("tiled", (2, 9, 9, 96), (3, 3), "SAME", (1, 1)),
    ("tiled", (1, 10, 10, 32), (5, 5), ((2, 2), (2, 2)), (1, 1)),
    ("tiled", (2, 12, 12, 128), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ("v2", (16, 56, 56, 128), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ("v2", (3, 9, 9, 8), (3, 3), ((1, 1), (1, 1)), (2, 2)),
    ("v2", (2, 7, 9, 4), (3, 3), "SAME", (2, 2)),
    ("v2", (2, 7, 7, 4), (5, 5), ((2, 2), (2, 2)), (1, 1)),
])
def test_cuda_kernel_matches_plain(entry, shape, ks, pad, strides):
    """The CUDA kernel against its plain version on the card, at the
    main-path shapes and the odd cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        shape).astype(np.float32)).cuda()
    fn = tpg.patch_gram_tiled if entry == "tiled" else tpg.patch_gram_v2
    before = fn.launches
    got = fn(x, ks, pad, strides)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, fn(x, ks, pad, strides))     # no atomics
    want = tpg.patch_gram_plain(x, ks, pad, strides)
    _assert_gram_close(got.cpu().numpy(), want.cpu().numpy())
