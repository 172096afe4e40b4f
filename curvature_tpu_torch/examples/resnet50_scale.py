"""Production-scale example: ResNet-50 KFAC on the card.

Port of ``examples/resnet50_scale.py``: bfloat16 compute (``--bf16``),
device prefetch (``data.prefetch.DevicePrefetcher``: pinned copies on a
side stream), mesh sharding (``--parallel``: the updates split over the
data axis of every rank of a ``torch.distributed.run`` launch, the
predictor's ensemble over a sample axis where the mesh has one), the
factor-update rate, the split-damped invert and the serving predictor
with its uncertainty decomposition, on synthetic data drawn from numpy
seed 0 (swap the loader for a real ImageNet one). The patch-Gram kernels
run where JAX's routes send them.

    python -m curvature_tpu_torch.examples.resnet50_scale [--bf16]
    python -m torch.distributed.run --nproc_per_node 2 \
        -m curvature_tpu_torch.examples.resnet50_scale --parallel
"""
import argparse
import time

import numpy as np
import torch

from curvature_tpu_torch import estimators, models, parallel
from curvature_tpu_torch.data.prefetch import DevicePrefetcher
from curvature_tpu_torch.eval import BayesianPredictor
from curvature_tpu_torch.pipelines.common import model_input
from curvature_tpu_torch.utils.device import resolve_device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    """Returns {"img_s": factor-update rate, "epistemic": the mean
    epistemic uncertainty of the first batch}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--platform", default="")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--size", type=int, default=224,
                    help="image side (ImageNet's 224)")
    ap.add_argument("--classes", type=int, default=1000)
    ap.add_argument("--samples", type=int, default=30)
    ap.add_argument("--parallel", action="store_true",
                    help="split the updates over every rank's data axis")
    ap.add_argument("--mesh", default="", help="axis spec, e.g. data:2")
    args = ap.parse_args(argv)
    # before the model is built: the process group picks this rank's GPU
    if args.parallel or args.mesh:
        parallel.initialize(device="cpu" if args.platform == "cpu" else None)
    mesh = parallel.build_mesh(args)
    device = resolve_device("cpu" if args.platform == "cpu" else None)
    if device.type == "cuda":
        # strict f32 where f32 is asked for (cuDNN convs default to TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    print("Building ResNet-50")
    model = models.resnet50(num_classes=args.classes, device=device)
    models.load_jax_variables(model, models.seeded_variables(model, 0))
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    est = estimators.KFAC(
        model, compute_dtype=torch.bfloat16 if args.bf16 else None)
    if mesh is not None:
        est.use_mesh(mesh)

    # synthetic NHWC input pipeline with device prefetch
    host = np.random.default_rng(0)
    batches = [(host.standard_normal((args.batch, args.size, args.size, 3),
                                     dtype=np.float32),
                np.zeros(args.batch, np.int64)) for _ in range(4)]
    loader = DevicePrefetcher(batches, device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    print("Estimating factors")
    x0 = next(iter(loader))[0]
    est.update(model_input(x0), generator=gen)          # warm-up
    _sync(device)
    t0 = time.perf_counter()
    n = 0
    for _ in range(args.steps):
        for x, _ in loader:
            est.update(model_input(x), generator=gen)
            n += args.batch
    _sync(device)
    img_s = n / (time.perf_counter() - t0)
    print(f"factor update: {img_s:.0f} img/s")

    print("Invert + predictor")
    est.invert(add=1.0, multiply=18916.0)           # README.rst ResNet18 row
    pred = BayesianPredictor(model, est, samples=args.samples,
                             generator=torch.Generator(device=device)
                             .manual_seed(1), mesh=mesh)
    out = pred(model_input(torch.as_tensor(batches[0][0], device=device)))
    epistemic = float(out.epistemic.mean())
    print("mean prob shape:", tuple(out.mean.shape),
          "| mean epistemic:", epistemic)
    return {"img_s": img_s, "epistemic": epistemic}


if __name__ == "__main__":
    main()
