#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``curvature_tpu_torch``).

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py              # what CI runs
    python3 chip_smoke.py --profile    # adds a device-time breakdown of one
                                       # update of each path (and of the
                                       # ResNet-18 pipeline's)
    python3 chip_smoke.py --kernels    # builds, checks and times the kernels
                                       # only, with the f32 sym_gram split
                                       # sweep
    python3 chip_smoke.py --lm         # builds the kernels, runs the
                                       # causal-LM phase only
    python3 chip_smoke.py --grouped    # builds the kernels, runs the
                                       # grouped-conv phase only
    python3 chip_smoke.py --hyper      # builds the kernels and the factor
                                       # files, runs the damping-search
                                       # phase only
    python3 chip_smoke.py --training   # builds the kernels, runs the
                                       # training phase only (with
                                       # --profile: one KFAC-optimizer step
                                       # of ResNet-18 too)
    python3 chip_smoke.py --zoo        # builds the kernels, runs the
                                       # classic-zoo phase only (with
                                       # --profile: one DenseNet-121
                                       # update too)
    python3 chip_smoke.py --transformers  # builds the kernels, runs the
                                       # vision-transformer phase only
                                       # (with --profile: one ViT-B/16
                                       # update too)

It builds the CUDA kernels from ``curvature_tpu_torch/ops/cuda/csrc``,
counts the tensor-core (HGMMA) instructions of each kernel in their SASS
(every tile kernel must have them, the f32 pre-pass and the reduces
none), holds each kernel (patch_gram_tiled, patch_gram_v2, patch_gram,
sym_gram with its f32 pre-pass; f32 and bf16) against its plain PyTorch
version on the card, including cases whose blocks each sum a full
``MAX_CHAIN_TOKENS`` chain, then drives
three paths of ResNet-50 (ImageNet stem, 1000 classes, 224x224, MC=1,
seeded weights), named after ``bench.py``'s rows:

  * ``resnet50_kfac_update_img_s``: the KFAC Laplace loop in f32 at B=16,
    4 factor updates, split-damped inversion, a 30-sample posterior
    ensemble, and the NN/BNN eval on 2 synthetic test batches;
  * ``resnet50_kfac_update_bf16_b32_img_s``: KFAC updates with
    ``compute_dtype=bfloat16`` at B=32 (layer2.0.conv2 through the v2
    kernel in bf16);
  * ``resnet50_kfac_update_bf16_sub4_img_s``: bf16 with
    ``token_subsample=0.25`` at B=16 (no Gram kernel, the JAX gate);

then the rest of the estimator ladder in f32 at B=16 (JAX
pipelines/factors.py): Diagonal, EFB from the f32 KFAC factors, INF from
EFB's diags, lambdas and eigenvectors (rank 100, bucket 8), and
BlockDiagonal on ``layer1.0.conv1``, each through update (no Gram kernel),
invert at its own damping (``LADDER_DAMPING``), a 30-sample ensemble and
the BNN eval; and a dense check of all
five estimators on ``layer1.0.conv1`` against their damped precision
formed in float64. The patch-Gram checks include strides outside (1, 1)
and (2, 2), which ``patch_gram_v2`` runs through the kernel's
run-time-stride instance, and the shapes ResNet-18 gives the kernels.

Then the pipeline CLIs, each ``main(argv)`` called in-process, writing
under ``build/pipelines``:

  * LeNet-5 on the bundled digits with the bundled trained weights:
    ``factors`` for diag, kfac and efb (full ``update_batches`` chunks and
    a ragged tail), ``inf`` at rank 100, then ``evaluate`` for kfac at
    the blitz's damping, plain and with the 19-step ``--fgsm`` sweep; the
    NN and BNN accuracy must be well above chance;
  * ResNet-18 (CIFAR stem) on synthetic data at full width: ``factors``
    kfac (16 batches of 32, two ``update_batches`` chunks) whose kernel
    launches must equal JAX's routes (``R18_ROUTES``, held against JAX's
    dispatch by tests/test_torch_pipelines.py) times the updates, the A
    factors of a tiled stride-1, the tiled stride-2 and the v2 layer
    against the plain path, then efb, diag and inf, ``evaluate --ood``
    for kfac and efb (AUROC), and kfac in bf16.

Then the damping search and the predictives (``hyper_phase``) on the
pipeline phase's factor files: on LeNet-5 every ``hyper`` optimizer
(random with the boundary points, grid, gp, forest, gbrt, ``--layer``)
and the evidence by gp and gradient ascent, ``evaluate`` at the searched
damping, the closed-form and linearized predictives, ``BayesianPredictor``,
the ``laplace`` facade and temperature scaling; on ResNet-18 the sampled
and evidence searches and ``evaluate --ood --predictive``; on ResNet-50's
f32 KFAC factors the batched evaluator and the evidence. None launches a
Gram kernel; the seconds per candidate are printed.

Then training (``training_phase``), each CLI writing under
``build/training``: LeNet-5 trained by SGD on the digits from its seeded
initialization, its test accuracy held within 3 points of the JAX
package's with the same flags (``JAX_LENET_TEST_ACC``), then ``factors``
-> ``hyper`` -> ``evaluate`` on the checkpoint it wrote (BNN above 50%),
``loss_landscape --loss1d`` and ``--loss2d`` twice each (the second call
must compute nothing), ``--swag`` and ``evaluate --estimator swag``;
ResNet-18 at full width with SGD, Adam and ``--optimizer kfac``, whose
factor passes launch the patch-Gram kernels by JAX's routes
(``R18_ROUTES`` per pass) and whose A factors are held against the plain
path, SWAG with ``evaluate --bn_update --ood``, and an 11-point loss
line. Nothing else in the phase launches a Gram kernel; it prints each
optimizer's step ms and img/s, the KFAC optimizer's re-invert and the
seconds per landscape point.

Then the grouped and depthwise convolutions (``grouped_phase``), none
launching a Gram kernel by JAX's routes: ResNeXt-50 32x4d and
EfficientNet-B0 at 224², B=16 through the KFAC loop of JAX's
``benchmarks/suite.py`` (``*_kfac_update_img_s``, ``*_kfac_invert``,
``*_bnn30_eval_fwd_img_s``, and ``*_kfac_update_bf16_sub4_img_s``), the
ladder on EfficientNet-B0, the dense check on ResNeXt's grouped
``layer1.0.conv2``, a ConvNeXt-T update and eval, and the MobileNetV2
``--data synthetic`` CLI chain.

Then the reference's classic torchvision CNNs (``zoo_phase``), under
``build/zoo``: DenseNet-121 at 224², B=16 through the KFAC loop
(``densenet121_kfac_update_img_s``, its 16 denseblock4 3x3 convs an
update through the tiled kernel, invert at the reference's DenseNet-121
damping, ``densenet121_bnn30_eval_img_s``, the bf16
``token_subsample=0.25`` rate); one update, invert and a 2-sample eval of
DenseNet-161, VGG-16 (its 25,089-wide ``classifier.0`` A factor built and
inverted), Inception v3 at 299², GoogLeNet, AlexNet and SqueezeNet 1.1
at B=8; the CLI chain ``factors -> evaluate --ood`` of DenseNet-121 on a
CIFAR-10 pickle tree and an SVHN .mat written there, from a
torchvision-layout ``.pth``, its batches through ``DevicePrefetcher``;
and ``mlp`` with ``loss='gaussian'`` on a UCI CSV. Every update's
launches are asserted from JAX's routes (``ZOO_ROUTES``) and every
kernel-routed layer's A factor is held against the plain path.

Then the JAX zoo's vision transformers (``transformer_phase``) at 224²,
B=16, 1000 classes: ViT-B/16 through JAX's ``vit_pipeline`` with
``attention_qkv_split`` (``vit_b16_kfac_update_img_s``, the 50-layer
invert ``vit_b16_kfac_invert_50layers``, ``vit_b16_bnn30_eval_fwd_img_s``),
its head split, bf16 and ``scan_blocks`` checks; Swin-T through the same
loop and Swin-V2-T; MaxViT-T, whose f32 update launches the tiled kernel
once (``stem.1.0``), held against the plain path, and none in bf16; the
ViT-B/16 ``--qkv_split`` and Swin-T CLIs under ``build/transformers``.
Last the causal-LM phase.

Every failed check raises. The last line of standard output is the
``{"ok": true, ...}`` JSON object; the line before it is the ``kernels``
JSON object. It exits non-zero, printing no result, where there is no
CUDA device or where the package is not beside it.
"""
import argparse
import functools
import json
import math
import subprocess
import sys
import time

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, dense TF32
#: and BF16 on the tensor cores (f32 accumulation, what wgmma computes),
#: HBM3. f32 Grams run 3xTF32 (csrc/tf32x3_gram.cuh): three TF32 products
#: per f32 product, so their bound is 3x the FLOP at the TF32 rate; the
#: strict FP32 FMA figure (what the kernels ran before the tensor cores)
#: stays in each f32 record as bound_fp32_fma_ms
PEAK_FLOPS = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}
TF32X3 = 3
PEAK_BYTES_S = 3.35e12
#: the JAX tests' parity bars: patch Gram (tests/test_pallas_kernels.py:31)
#: and sym_gram (:141, of max(max|want|, 1))
GRAM_RTOL = 1e-4
SYM_RTOL = 2e-5
#: bf16 compute against f32 factors (tests/test_capture.py:137)
BF16_RTOL = 2e-2
BATCH, SIZE, CLASSES, UPDATES, SAMPLES = 16, 224, 1000, 4, 30
BATCH_B32 = 32
ADD, MULTIPLY = 1.0, 18916.0
#: the estimator ladder (JAX pipelines/factors.py:39-58): INF's rank and
#: index-set bucket, as the pipeline calls INF.update, and max_product (0:
#: the reference's uncapped index sets)
INF_RANK, INF_BUCKET, INF_MAX_PRODUCT = 100, 8, 0
#: the ladder's invert(add, multiply): the reference's best (norm, scale)
#: of each estimator for ResNet-50 on ImageNet (BASELINE.md, from its
#: README.rst:259-267); Block, which has no row, takes Diagonal's. At
#: KFAC's (ADD, MULTIPLY) the Diagonal, EFB and INF ensembles of the random
#: network overflow: a prior standard deviation of 1 on every weight whose
#: Fisher is near 0
LADDER_DAMPING = {"diagonal": (16.0, 7387.0), "efb": (11.0, 75113871.0),
                  "inf": (145307.0, 60.0), "block": (16.0, 7387.0)}
#: the layer of the Block phase and of the dense check: 1x1, 64 -> 64,
#: 4,096 parameters (a 64 MiB Block state)
DENSE_LAYER = "layer1.0.conv1"
#: the estimators against their dense float64 precision: the constant of
#: the rounding bounds of ``dense_bars``
DENSE_C = 16
PATHS = ("resnet50_kfac_update_img_s", "resnet50_kfac_update_bf16_b32_img_s",
         "resnet50_kfac_update_bf16_sub4_img_s")
#: the pipeline phase: the ResNet-18 factors runs whose launches are read
R18_PATHS = ("resnet18_synthetic_factors_kfac_f32",
             "resnet18_synthetic_factors_kfac_bf16")
#: where the CLIs write (git-ignored)
PIPE_ROOT = "build/pipelines"
#: LeNet-5 on the digits: 512 training digits in 16 batches of 32, two
#: update_batches chunks of 6 and a ragged tail of 4
LENET_ARGV = ["--model", "lenet5", "--data", "mnist", "--batch_size", "32",
              "--scan_chunk", "6"]
LENET_UPDATES = 16
#: the blitz's damping (examples/blitz.py:36-40): BNN accuracy equals the
#: NN's on the digits
BLITZ = ["--norm", "1", "--scale", "5e4"]
#: ResNet-18 CIFAR on synthetic data: 512 images in 16 batches of 32, two
#: update_batches chunks of 8 (the default --scan_chunk)
R18_ARGV = ["--model", "resnet18", "--data", "synthetic", "--batch_size",
            "32"]
R18_UPDATES = 16
#: kernel launches of one ResNet-18 kfac update at B = 32, by path: JAX's
#: routes (the correlation gate, then select_patch_gram), eight tiled
#: layers (layer1's four convs, layer2.0.conv1 at stride 2, layer2's three
#: other convs at C = 128) and one v2 layer (layer3.0.conv1) in f32, the
#: v2 layer alone in bf16
R18_ROUTES = {R18_PATHS[0]: {"tiled": 8, "v2": 1},
              R18_PATHS[1]: {"tiled": 0, "v2": 1}}
#: the CLIs' default --mc_samples (utils/config.py)
PIPE_MC = 10
#: the random network's damping: a prior standard deviation of at most
#: 1/sqrt(norm) = 0.01 per weight against He-init scales of 0.02-0.08
R18_DAMPING = ["--norm", "1e4", "--scale", "1e4"]
#: the A factors held against the plain path after the kfac run: a tiled
#: stride-1 layer at C = 64 and at C = 128, the tiled stride-2 layer, the
#: v2 layer
R18_CHECKED = {"layer1.0.conv1": "tiled", "layer2.1.conv1": "tiled",
               "layer2.0.conv1": "tiled", "layer3.0.conv1": "v2"}
#: the causal-LM phase: GPT-2 124M (bench.py:265-282) at its full width,
#: depth-stacked, B=8, T=512, loss 'lm', the blocks' layers ('h.*'); the
#: rate's blocks of updates (bench.py:131-142: one warm update, best of 3)
LM_PATH = "gpt2_124m_kfac_update_tok_s"
LM_BATCH, LM_T, LM_VOCAB, LM_UPDATES = 8, 512, 50257, 10
#: the ladder's batches, the short per-token BNN evals' samples, and the
#: damping of the random GPT-2's posteriors: a prior standard deviation
#: of at most 1/sqrt(norm) ~ 0.003 per weight against N(0, 0.02) kernels
LM_LADDER_BATCHES, LM_LADDER_SAMPLES = 4, 10
LM_DAMPING = (1e5, 1e4)
#: the vocabulary head's blocked G: 50 blocks of 1,024 (51,200 padded rows)
LM_G_BLOCK = 1024
#: INF on the 124M layers: rank 100 as the pipeline, the completed index
#: product capped at 1,024 per depth (R x R float64 eigh per depth)
LM_INF_MAX_PRODUCT = 1024
#: the CLIs: JAX tests/test_lm_pipeline.py's configuration, then the
#: vocabulary-scale per-token stats route (vocab >= 8192)
LM_ARGV = ["--model", "gpt2_tiny", "--data", "tokens", "--seq_len", "16",
           "--batch_size", "32", "--scan_blocks"]
LM_VOCAB_ARGV = ["--model", "gpt2_tiny", "--data", "tokens", "--vocab",
                 "50257", "--seq_len", "64", "--layers", "h.*"]
LM_CLI_DAMPING = ["--norm", "1e5", "--scale", "1e4"]
#: the damping-search phase (JAX pipelines/hyper.py, its objectives and
#: the predictives): the LeNet-5 searches as (estimator, flags); --layer
#: evaluates ~170 candidates, at 10 samples each (23.3 s of the phase at
#: the default 30)
HYPER_LENET = (("kfac", ["--optimizer", "random", "--calls", "16",
                         "--boundaries"]),
               ("kfac", ["--optimizer", "grid"]),
               ("diag", ["--optimizer", "gp", "--calls", "12"]),
               ("efb", ["--optimizer", "forest", "--calls", "10"]),
               ("kfac", ["--optimizer", "gbrt", "--calls", "10"]),
               ("kfac", ["--layer", "--calls", "4", "--samples", "10"]))
HYPER_LENET_MARGLIK = (["--optimizer", "gp", "--calls", "12"],
                       ["--optimizer", "grad", "--calls", "100"],
                       ["--optimizer", "grad", "--calls", "100", "--layer"])
#: ResNet-18: the sampled searches' calls and samples, the evidence's
#: searches, the predictives of evaluate --ood
HYPER_R18 = ["--optimizer", "random", "--calls", "8", "--samples", "10"]
HYPER_R18_MARGLIK = (["--optimizer", "gp", "--calls", "12"],
                     ["--optimizer", "grad", "--calls", "100"])
HYPER_PREDICTIVES = ("probit", "bridge", "linearized", "linearized_probit")
#: evaluate --predictive's posterior samples (the CLI's default is 30: a
#: linearized run at 30 took 16-18 s of the phase's time)
HYPER_PREDICTIVE_SAMPLES = ["--samples", "10"]
#: the LeNet-5 FGSM sweeps (at the blitz's and the searched dampings, and
#: SWAG's) take 10 posterior samples: at 30 each cost 13-17 s
FGSM_CHAIN_SAMPLES = ["--samples", "10"]
#: ResNet-50 (the main path's f32 KFAC factors): the batched evaluator's
#: candidates (S=10, the two test batches as validation) and the
#: evidence's
HYPER_R50_CANDIDATES = ([1.0, 10.0, 100.0, 1e3], [18916.0, 1e4, 1e3, 1e2])
HYPER_R50_SAMPLES = 10
HYPER_R50_EVIDENCE = [(a, b) for a in (1.0, 1e2, 1e4, 1e6)
                      for b in (1e2, 18916.0)]
#: the grouped phase (JAX benchmarks/suite.py:216-263, grouped_pipeline):
#: ResNeXt-50 32x4d and EfficientNet-B0 at 224², B=16, f32, MC=1, 1000
#: classes; the bf16 token_subsample=0.25 update under the suite's tag
GROUPED_MODELS = ("resnext50_32x4d", "efficientnet_b0")
GROUPED_TAG = "_bf16_sub4"
#: the dense check's grouped layer: 128 out, 32 groups of 4 channels, 36
#: columns, 4,608 parameters
GROUPED_DENSE_LAYER = "layer1.0.conv2"
#: the EfficientNet-B0 ladder's Block layer: the depthwise 3x3 s2 over 96
#: channels (96 groups of 9 columns, 864 parameters)
GROUPED_BLOCK_LAYER = "features.2.0.block.1.0"
#: the CLI chain (JAX benchmarks/NOTES.md:408-414): MobileNetV2 on
#: synthetic data, INF at rank 50, the random network's damping of
#: R18_DAMPING
GROUPED_ARGV = ["--model", "mobilenet_v2", "--data", "synthetic"]
GROUPED_INF_RANK = "50"
#: the zoo phase (the reference's torchvision CNNs, reference
#: factors.py:80-84): DenseNet-121 at 224², ImageNet head, f32 B=16
#: through the ResNet-50 row's KFAC loop (bench.py), under its names
ZOO_PATHS = ("densenet121_kfac_update_img_s",
             "densenet121_kfac_update_bf16_sub4_img_s")
#: then one update (B=8), invert and a 2-sample eval of each other family
#: at full width (Inception v3 at 299², the rest at 224²)
ZOO_FAMILIES = ("densenet161", "vgg16", "inception_v3", "googlenet",
                "alexnet", "squeezenet1_1")
ZOO_BATCH, ZOO_SAMPLES = 8, 2
#: invert(add, multiply): the reference's best KFAC (norm, scale) for
#: DenseNet-121 and -161 on ImageNet (BASELINE.md, from its
#: README.rst:259-267): at ResNet-50's (ADD, MULTIPLY) the random
#: DenseNet's ensemble overflows through its 120 BatchNorms. The families
#: without a row take (1e8, 1e4): the A factors of VGG-16's and AlexNet's
#: dense heads at B=8 have rank 8 (VGG-16's classifier.0 a largest
#: eigenvalue of 2.2e5 on these inputs, measured on the CPU), and at
#: R18_DAMPING's (1e4, 1e4) the damped precision's condition number
#: (2.2e5) leaves the f32 inverse L^-T L^-1 of 25,089 (9,217) columns
#: indefinite: the inverse Cholesky raises. (1e8, 1e4) bounds it at 2.2e3
ZOO_DAMPING = {"densenet121": (2312.0, 12791.0),
               "densenet161": (260.0, 17780.0)}
ZOO_DEFAULT_DAMPING = (1e8, 1e4)
#: (tiled, v2) kernel launches of one f32 update by JAX's routes, per
#: (model, batch, extent): held against JAX's dispatch by
#: tests/test_torch_zoo_classic_layers.py
ZOO_ROUTES = {("densenet121", 16, 224): (16, 0),
              ("densenet121", 32, 32): (58, 0),
              ("densenet161", 8, 224): (0, 0), ("vgg16", 8, 224): (2, 0),
              ("inception_v3", 8, 299): (10, 27),
              ("googlenet", 8, 224): (9, 0), ("alexnet", 8, 224): (0, 0),
              ("squeezenet1_1", 8, 224): (6, 0)}
#: VGG-16's classifier.0 has fan-in 25,088: its A factor (25,089 wide,
#: 2.5 GB in f32) is past KFAC's default max_factor_dim of 16,384
ZOO_MAX_FACTOR_DIM = 25089
#: the CLI chain on array-format files this phase writes: a CIFAR-10
#: pickle tree (5 batches of 64 training images, 256 test), an SVHN test
#: .mat of 256 (the OOD pair), a torchvision-layout densenet121_cifar10.pth;
#: factors kfac (10 updates of 32 through DevicePrefetcher) -> evaluate
#: --ood
ZOO_ROOT = "build/zoo"
ZOO_CIFAR_TRAIN, ZOO_TEST = 64, 256
ZOO_ARGV = ["--model", "densenet121", "--data", "cifar10", "--batch_size",
            "32"]
ZOO_CLI_UPDATES = 10
ZOO_CLI_PATH = "densenet121_cifar10_factors_kfac_f32"
#: the regression cell: mlp on a synthetic UCI CSV (FEATURES inputs, one
#: target), loss='gaussian', batches of 64
ZOO_UCI_ROWS, ZOO_UCI_FEATURES = 1024, 8
#: kernel record -> the zoo paths whose f32 launches it counts
ZOO_RECORD_PATHS = {
    "patch_gram_tiled_densenet121": (ZOO_PATHS[0], ZOO_CLI_PATH),
    "patch_gram_tiled_zoo": ("vgg16_kfac_update", "inception_v3_kfac_update",
                             "googlenet_kfac_update",
                             "squeezenet1_1_kfac_update"),
    "patch_gram_v2_inception_v3": ("inception_v3_kfac_update",)}
#: the training phase (JAX pipelines/training.py, optim.py,
#: estimators/swag.py, pipelines/loss_landscape.py), under its own root: a
#: weights/lenet5_mnist.npz under PIPE_ROOT would take the bundled
#: asset's place in the pipeline phase
TRAIN_ROOT = "build/training"
#: LeNet-5 on the digits (512 training digits, B=32, 16 steps an epoch),
#: SGD with momentum 0.9 from the seeded initialization (numpy seed 42,
#: written as the checkpoint first); the flags and the JAX package's test
#: accuracy with them on the CPU are tests/test_torch_training.py's
#: CHIP_FLAGS and its printed reading (the card's run must come within 3
#: points)
TRAIN_LENET = ["--epochs", "20", "--lr", "0.01"]
TRAIN_LENET_SEED = 42
JAX_LENET_TEST_ACC = 86.328125
#: the chain on the trained checkpoint: the damping search, then SWAG, 8
#: more epochs of which the SWA window takes the last 2, sampled at the
#: paper's covariance (multiply 1; add is ignored)
TRAIN_HYPER = ["--optimizer", "random", "--calls", "16"]
TRAIN_SWAG = ["--epochs", "8", "--lr", "0.01", "--swag"]
TRAIN_SWAG_DAMPING = ["--norm", "1", "--scale", "1"]
#: ResNet-18 CIFAR at full width on synthetic data: training's train/val
#: split holds 256 images (pipelines/common.build_data), 8 steps of 32 an
#: epoch; each optimizer from the seeded initialization under its own root
TRAIN_R18 = ["--epochs", "2"]
#: its SWAG run keeps 5 deviations (the CLI's default 20: an 880 MB
#: deviation buffer, most of that run's 21 s its compressed write)
TRAIN_R18_SWAG_RANK = ["--swag_rank", "5"]
#: each optimizer's flags: Adam at its usual rate, the KFAC optimizer
#: (damping 1e-2, JAX's default) at 0.01: both diverge at 0.05
TRAIN_R18_OPTS = {"sgd": ["--lr", "0.05"], "adam": ["--lr", "1e-3"],
                  "kfac": ["--lr", "0.01"]}
TRAIN_PATH = "resnet18_synthetic_training_kfac_f32"
#: the loss line at full width (the CLI's is 51 points)
LANDSCAPE_R18_POINTS = 11
#: the transformer phase (JAX benchmarks/suite.py:267-313, vit_pipeline):
#: ViT-B/16 with the qkv split, then Swin-T and MaxViT-T, at 224², B=16,
#: f32, MC=1, 1000 classes, under the suite's names
TRANSFORMER_PATHS = ("vit_b16_kfac_update_img_s", "swin_t_kfac_update_img_s",
                     "maxvit_t_kfac_update_img_s")
#: (tiled, v2) launches of one f32 MaxViT-T update at 224², B=16: stem.1.0
#: (3x3 s1, C=64 at 112²); none in bf16 (held against JAX's dispatch by
#: tests/test_torch_zoo_transformers.py)
MAXVIT_ROUTES = (1, 0)
#: ViT-B/16's stacked factors against the unrolled model's, of max (GPT-2's
#: stacked slices came within 3.8e-6 on this card)
SCAN_RTOL = 1e-5
#: Swin-V2-T at torchvision's 256² (its weights' resolution): every stage's
#: map a whole number of 8x8 windows. At 224² the 28² and 7² stages pad,
#: the padding tokens' keys are exactly zero (V2 removes the key bias), the
#: cosine attention's normalize divides them by its 1e-12 floor, and the
#: qkv G factors reach eigenvalues of 8.1e20 (B=2, seeded weights,
#: measured on the CPU; JAX differentiates the norm at zero to NaN there):
#: invert(ADD, MULTIPLY) is indefinite in f32. At 256² the largest factor
#: eigenvalue is 1.9e4 and the invert holds
SWIN_V2_SIZE = 256
#: the CLIs (synthetic 32² images: a 2x2 patch grid), each narrowed by
#: --layers so that its npz stays small: ViT-B/16's last encoder layer and
#: head with the qkv split, Swin-T's last stage and head
TRANSFORMER_ROOT = "build/transformers"
VIT_ARGV = ["--model", "vit_b_16", "--data", "synthetic", "--qkv_split",
            "--layers", "encoder.layers.encoder_layer_11.*,heads.head"]
SWIN_ARGV = ["--model", "swin_t", "--data", "synthetic", "--layers",
             "features.7.*,head"]
#: kernel record -> the transformer paths whose f32 launches it counts
TRANSFORMER_RECORD_PATHS = {"patch_gram_tiled_maxvit_t":
                            (TRANSFORMER_PATHS[2],)}
SAME1 = ((1, 1), (1, 1))
#: entry -> [main-path shape first, then odd cases]: (shape, kernel,
#: padding, strides); sym_gram cases are (N, F)
PATCH_CASES = {
    # the odd cases of tests/test_pallas_kernels.py (SAME with odd H/W,
    # 5x5, stride-2 odd grid)
    "patch_gram_tiled": [
        ((16, 56, 56, 64), (3, 3), SAME1, (1, 1)),
        ((2, 9, 9, 96), (3, 3), "SAME", (1, 1)),
        ((1, 10, 10, 32), (5, 5), ((2, 2), (2, 2)), (1, 1)),
        ((2, 12, 12, 128), (3, 3), SAME1, (2, 2)),
        ((3, 9, 9, 64), (3, 3), SAME1, (2, 2)),
    ],
    "patch_gram_v2": [
        ((16, 56, 56, 128), (3, 3), SAME1, (2, 2)),
        ((3, 9, 9, 8), (3, 3), SAME1, (2, 2)),
        ((2, 7, 9, 4), (3, 3), "SAME", (2, 2)),
        ((2, 12, 12, 4), (5, 5), ((2, 2), (2, 2)), (2, 2)),
        ((2, 7, 7, 4), (5, 5), ((2, 2), (2, 2)), (1, 1)),
    ],
    # strides outside COMPILED_STRIDES, through patch_gram_v2's
    # run-time-stride instance: layer2.0.conv2's input at stride (3, 3)
    # first, then the small cases of tests/test_torch_patch_gram.py
    "patch_gram_v2_any_stride": [
        ((16, 56, 56, 128), (3, 3), SAME1, (3, 3)),
        ((2, 9, 9, 4), (3, 3), SAME1, (3, 3)),
        ((2, 8, 8, 4), (3, 3), SAME1, (1, 2)),
        ((2, 8, 8, 4), (3, 3), SAME1, (2, 1)),
    ],
    # ResNet-18's (B=32, 32x32 input, after the maxpool): layer2.0.conv1
    # at stride 2 first, then layer1's and layer2's stride-1 convs
    "patch_gram_tiled_resnet18": [
        ((32, 16, 16, 64), (3, 3), SAME1, (2, 2)),
        ((32, 16, 16, 64), (3, 3), SAME1, (1, 1)),
        ((32, 8, 8, 128), (3, 3), SAME1, (1, 1)),
    ],
    # ResNet-18's layer3.0.conv1
    "patch_gram_v2_resnet18": [
        ((32, 8, 8, 128), (3, 3), SAME1, (2, 2)),
    ],
    # DenseNet-121's denseblock4 3x3 convs at 224² (B=16), then the CIFAR
    # CLI's at 4², 2² and 1² (B=32): most window taps in the padding, 16 to
    # 512 tokens, under one 128-token chunk at 1²
    "patch_gram_tiled_densenet121": [
        ((16, 7, 7, 128), (3, 3), SAME1, (1, 1)),
        ((32, 4, 4, 128), (3, 3), SAME1, (1, 1)),
        ((32, 2, 2, 128), (3, 3), SAME1, (1, 1)),
        ((32, 1, 1, 128), (3, 3), SAME1, (1, 1)),
    ],
    # the other zoo families' tiled layers at B=8: VGG-16's features.2,
    # Inception v3's Conv2d_2b_3x3 and its 3x3 over 64 channels at 35²,
    # GoogLeNet's conv3, SqueezeNet 1.1's last expand3x3
    "patch_gram_tiled_zoo": [
        ((8, 224, 224, 64), (3, 3), SAME1, (1, 1)),
        ((8, 147, 147, 32), (3, 3), SAME1, (1, 1)),
        ((8, 35, 35, 64), (3, 3), SAME1, (1, 1)),
        ((8, 56, 56, 64), (3, 3), SAME1, (1, 1)),
        ((8, 13, 13, 64), (3, 3), SAME1, (1, 1)),
    ],
    # MaxViT-T's stem.1.0 at 224², B=16: 3x3 s1 over 64 channels at 112²
    "patch_gram_tiled_maxvit_t": [
        ((16, 112, 112, 64), (3, 3), SAME1, (1, 1)),
    ],
    # Inception v3's v2 layers at B=8, 299²: the 1x7 and 7x1 convs of
    # Mixed_6* (asymmetric pads), the 1x3 and 3x1 of Mixed_7*, the stride-2
    # 3x3 of Mixed_6a's double branch
    "patch_gram_v2_inception_v3": [
        ((8, 17, 17, 128), (1, 7), ((0, 0), (3, 3)), (1, 1)),
        ((8, 17, 17, 160), (7, 1), ((3, 3), (0, 0)), (1, 1)),
        ((8, 8, 8, 384), (1, 3), ((0, 0), (1, 1)), (1, 1)),
        ((8, 8, 8, 384), (3, 1), ((1, 1), (0, 0)), (1, 1)),
        ((8, 35, 35, 96), (3, 3), ((0, 0), (0, 0)), (2, 2)),
    ],
    # the four shapes of tests/test_pallas_kernels.py:20-25 (2x2 VALID at
    # C=3, non-square 10x6)
    "patch_gram": [
        ((16, 56, 56, 64), (3, 3), SAME1, (1, 1)),
        ((2, 8, 8, 4), (3, 3), SAME1, (1, 1)),
        ((3, 10, 6, 8), (3, 3), ((0, 0), (0, 0)), (1, 1)),
        ((2, 7, 7, 4), (5, 5), ((2, 2), (2, 2)), (1, 1)),
        ((1, 9, 9, 3), (2, 2), ((0, 0), (0, 0)), (1, 1)),
    ],
}
#: record name -> the entry point it runs
ENTRY = {"patch_gram_v2_any_stride": "patch_gram_v2",
         "patch_gram_tiled_resnet18": "patch_gram_tiled",
         "patch_gram_v2_resnet18": "patch_gram_v2",
         "patch_gram_tiled_densenet121": "patch_gram_tiled",
         "patch_gram_tiled_zoo": "patch_gram_tiled",
         "patch_gram_tiled_maxvit_t": "patch_gram_tiled",
         "patch_gram_v2_inception_v3": "patch_gram_v2"}
#: record name -> the launch counter it reads (Counters), where not its own
COUNTER = dict(ENTRY, patch_gram_v2_any_stride="patch_gram_v2_any_stride")
#: bf16 boundary cases of the wgmma gather, run through patch_gram_v2 (its
#: odd cases above hold C = 4, the scalar gather, and C = 8)
BF16_PATCH_CASES = [
    # C = 96: 64-feature tiles straddle taps; F = 864 is not a multiple of
    # 64; N = 162 is not a multiple of one 64-token stage
    ((2, 9, 9, 96), (3, 3), SAME1, (1, 1)),
    ((1, 5, 5, 64), (3, 3), SAME1, (1, 1)),       # N = 25 < one stage
    ((4, 28, 28, 64), (3, 3), SAME1, (2, 2)),     # N = 784 in 3 splits
]
#: (784, 4609) is ResNet-50's layer4 3x3 patch matrix at B=16; (600, 1024)
#: has F % 8 == 0 (no padding in bf16)
SYM_CASES = [(784, 4609), (3136, 1025), (700, 577), (513, 2049), (600, 1024)]
#: N = 2 x MAX_CHAIN_TOKENS at F = 4609: one split fills the card, so the
#: chain cap alone sets the splits, and every block sums exactly a full
#: chain (f32 2 x 8,192 tokens, bf16 8 x BF16_CHAIN_TOKENS = 2,048)
SYM_CHAIN_CASE = (16384, 4609)
#: --kernels: f32 sym_gram shapes from 0.3 to 5.3 waves of 128-feature
#: block tiles on 132 SMs, each timed with one split and with the
#: wave-filling count, for the wrapper's ONE_PASS_WAVES
SPLIT_SWEEP = [(3136, 1025), (513, 2049), (784, 2305), (784, 3073),
               (784, 3585), (784, 4097), (784, 4609)]
#: run through patch_gram in f32 and bf16: N = 132 * 64 * 64 = 540,672 =
#: 66 x MAX_CHAIN_TOKENS, so every block of the 66 splits sums a full
#: 8,192-token chain in its tensor-core accumulator (F = 576)
CHAIN_CASE = ((132, 64, 64, 64), (3, 3), SAME1, (1, 1))
REPLACES = {
    "patch_gram_tiled": "curvature_tpu/ops/pallas/patch_gram.py:464",
    "patch_gram_v2": "curvature_tpu/ops/pallas/patch_gram.py:229",
    "patch_gram": "curvature_tpu/ops/pallas/patch_gram.py:114",
    "sym_gram": "curvature_tpu/ops/pallas/sym_gram.py:85",
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, min_ms=50.0, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events around
    back-to-back calls after ``warmup`` calls: at least 20 calls and about
    ``min_ms`` of device time, so that short kernels are not timed over a
    window of a few milliseconds."""
    import torch

    def timed(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return timed(max(20, min(2000, int(min_ms / max(timed(3), 1e-3)))))


def add_device_times(records):
    """Each record's device time per call by kernel name (torch.profiler)
    and its sum, ``device_ms``: the kernels' own time, where ``ms`` also
    holds the host's gaps between back-to-back wrapper calls that cannot
    be enqueued as fast as the card runs them (kernels of ~0.1 ms); and
    the shares of the split reduce and the f32 pre-pass in it. Run after
    the paths: a profiler run slows the host's later launches."""
    for rec in records:
        by_kernel = device_ms_by_kernel(rec.pop("call"))
        rec["device_ms_by_kernel"] = by_kernel
        rec["device_ms"] = sum(by_kernel.values())
        for part in ("reduce", "presplit"):
            rec[f"device_ms_{part}"] = sum(
                v for k, v in by_kernel.items() if f"{part}_kernel" in k)
        log(f"{rec['name']}: {rec['ms']:.4f} ms, device {rec['device_ms']:.4f}"
            f" ms ({rec['gather']} gather; {rec['tile']}), plain "
            f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f} / f32 "
            f"out {rec['library_f32_out_ms']}, bound {rec['bound_ms']:.4f} "
            f"({rec['bound_by']}); by kernel " + ", ".join(
                f"{k} {v:.4f}" for k, v in rec["device_ms_by_kernel"].items()))


def device_ms_by_kernel(fn, calls=5):
    """Device time per call of ``fn`` by kernel name (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def bound(ops, nbytes, rate):
    """(ms, by): the larger of ``ops`` at ``rate`` per second and the
    bytes at the card's memory rate."""
    ops_ms = ops / rate * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def bounds(flops, nbytes, dtype):
    """The record's bound keys for a Gram of ``flops`` FLOP over ``nbytes``
    bytes: bf16 at the BF16 tensor-core rate; f32 as 3xTF32 (3x the FLOP
    at the TF32 rate), with the strict FP32 FMA bound beside it."""
    if dtype == "bf16":
        ms, by = bound(flops, nbytes, PEAK_FLOPS["bf16"])
        return {"bound_ms": ms, "bound_by": by, "bound_fp32_fma_ms": None}
    ms, by = bound(TF32X3 * flops, nbytes, PEAK_FLOPS["tf32"])
    return {"bound_ms": ms, "bound_by": by,
            "bound_fp32_fma_ms": bound(flops, nbytes, PEAK_FLOPS["fp32"])[0]}


def gram_bound(shape, kernel_size, strides, pads, dtype, itemsize):
    """The patch Gram's bound keys: the lower triangle with its diagonal
    of the [F+1, F+1] Gram, N*(F+1)*(F+2) FLOP, against the input read once
    and the f32 output written once."""
    b, h, w, c = shape
    kh, kw = kernel_size
    (pt, pb), (pl, pr) = pads
    ho = (h + pt + pb - kh) // strides[0] + 1
    wo = (w + pl + pr - kw) // strides[1] + 1
    n, f1 = b * ho * wo, c * kh * kw + 1
    return bounds(n * f1 * (f1 + 1), b * h * w * c * itemsize + f1 * f1 * 4,
                  dtype)


def unfold(x_nhwc, kernel_size, pads, strides):
    """The [N, F] patch matrix by ``F.unfold`` (yardsticks only)."""
    import torch.nn.functional as F
    p = F.unfold(x_nhwc.permute(0, 3, 1, 2), kernel_size,
                 padding=(pads[0][0], pads[1][0]), stride=strides)
    return p.transpose(1, 2).reshape(-1, p.shape[1])


def yardsticks(dtype, p_of):
    """Library yardsticks, never called by the port, as {key: (name, fn)}:
    ``p.T @ p`` in the input's dtype (bf16 gives cuBLAS's bf16-output
    product) and, for bf16, ``torch.mm(..., out_dtype=torch.float32)``
    (f32 output, the kernels' contract) where this torch accepts it.
    ``p_of()`` builds the [N, F] matrix (the unfold counts in the time)."""
    import torch

    def same_out():
        p = p_of()
        return p.T @ p
    out = {"library_ms": (f"p.T @ p ({dtype} output)", same_out)}
    if dtype == "bf16":
        def f32_out():
            p = p_of()
            return torch.mm(p.T, p, out_dtype=torch.float32)
        try:
            f32_out()
            out["library_f32_out_ms"] = (
                "torch.mm(p.T, p, out_dtype=torch.float32)", f32_out)
        except (TypeError, RuntimeError, NotImplementedError) as e:
            log(f"  torch.mm out_dtype=float32 not available: {e}")
    return out


def time_yardsticks(dtype, p_of):
    times, names = {}, {}
    for key, (name, fn) in yardsticks(dtype, p_of).items():
        times[key] = cuda_ms(fn)
        names[key.replace("_ms", "_call")] = name
    times.setdefault("library_f32_out_ms", None)
    return {**times, **names}


#: (function, dtype) -> the kernel template that computes it, as it
#: appears in the SASS; the ``*wgmma_kernel`` ones run on the tensor cores
KERNEL_OF = {("patch", "f32"): "gram_tf32x3_wgmma_kernel",
             ("patch", "bf16"): "gram_wgmma_kernel",
             ("sym", "f32"): "sym_tf32x3_wgmma_kernel",
             ("sym", "bf16"): "sym_wgmma_kernel"}


def hgmma_counts(build):
    """Tensor-core (HGMMA) instructions per kernel in the SASS of the built
    libraries (``cuobjdump -sass``); raises if a ``*wgmma_kernel`` has none
    or any other kernel (the f32 pre-pass, the reduces) has some, or if a
    kernel of ``KERNEL_OF`` is missing."""
    import re
    import shutil
    from pathlib import Path
    tool = shutil.which("cuobjdump") or str(Path(build._nvcc()).parent
                                             / "cuobjdump")
    counts = {}
    for name in ("patch_gram", "sym_gram"):
        sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn and "HGMMA" in line:
                counts[fn] += 1
    for fn, n in sorted(counts.items()):
        log(f"  SASS {fn}: {n} HGMMA")
        wgmma = "wgmma_kernel" in fn
        if wgmma and n == 0:
            raise AssertionError(f"{fn}: no HGMMA in its SASS")
        if not wgmma and n:
            raise AssertionError(f"{fn}: HGMMA in a kernel off the tensor "
                                 "cores")
    for kernel in KERNEL_OF.values():
        if not any(kernel in fn for fn in counts):
            raise AssertionError(f"{kernel} not found in the SASS")
    return counts


def _record(name, dtype, shape, abs_err, rel, worst, cases, **times):
    function = ENTRY.get(name, name)
    return {"name": name if dtype == "f32" else f"{name}_{dtype}",
            "function": function, "counter": COUNTER.get(name, name),
            "dtype": dtype,
            "route": "cuda",
            "source": "curvature_tpu_torch/ops/cuda/csrc/"
                      + ("sym_gram.cu" if name == "sym_gram"
                         else "patch_gram.cu"),
            "replaces": REPLACES[function], "launches": None,
            "launches_by_path": None, "max_abs_err": abs_err,
            "max_rel_err": rel, "worst_rel_err_all_cases": worst,
            "cases": cases, "shape": list(shape), **times}


def _launch_twice(fn, *args):
    """One kernel result, after checking that a second launch gives the
    same bits (no atomics, a fixed reduction order)."""
    import torch
    got = fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, fn(*args)):
        raise AssertionError(f"{fn.__name__}: two launches differ (the "
                             "reduction must be deterministic)")
    return got


def check_patch_kernels(tpg, dtype):
    """Each patch-Gram entry against its plain version on the card, in
    ``dtype``; times at the main-path shape. Returns the records."""
    import numpy as np
    import torch
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(0)
    records = []
    for name, items in PATCH_CASES.items():
        fn = getattr(tpg, ENTRY.get(name, name))
        if name == "patch_gram_v2" and dtype == "bf16":
            # the bf16_b32 path's layer2.0.conv2, and the gather's edges
            items = [((BATCH_B32,) + items[0][0][1:],) + items[0][1:]] \
                + items[1:] + BF16_PATCH_CASES
        worst, main = 0.0, None
        for i, (shape, ks, pad, st) in enumerate(items):
            x = torch.from_numpy(rng.standard_normal(shape).astype(
                np.float32)).cuda().to(tdt)
            args = (x, ks, pad) if name == "patch_gram" else (x, ks, pad, st)
            got = _launch_twice(fn, *args)
            want = tpg.patch_gram_plain(x, ks, pad, st)
            abs_err = float((got - want).abs().max())
            rel = abs_err / float(want.abs().max())
            gather = tpg.gather_kind(x)
            log(f"  {name} {dtype} {shape} k={ks} pad={pad} s={st}: "
                f"splits={patch_splits(tpg, x, ks, pad, st)} gather={gather} "
                f"max_abs_err={abs_err:.3e} rel={rel:.3e}")
            if not (torch.isfinite(got).all() and rel <= GRAM_RTOL):
                raise AssertionError(
                    f"{name} {dtype} {shape}: kernel disagrees with its "
                    f"plain version (rel {rel:.3e} > {GRAM_RTOL})")
            worst = max(worst, rel)
            if i == 0:
                main = (x, ks, pad, st, args, abs_err, rel, gather)
        x, ks, pad, st, args, abs_err, rel, gather = main
        pads = tpg.resolve_padding(pad, x.shape[1], x.shape[2], ks, st)
        records.append(_record(
            name, dtype, x.shape, abs_err, rel, worst, len(items),
            gather=gather, ms=cuda_ms(lambda: fn(*args)),
            call=functools.partial(fn, *args),
            plain_ms=cuda_ms(lambda: tpg.patch_gram_plain(x, ks, pad, st)),
            **gram_bound(tuple(x.shape), ks, st, pads, dtype,
                         x.element_size()),
            **time_yardsticks(dtype, lambda: unfold(x, ks, pads, st))))
    records[-1]["chain_cap_rel_err"] = check_chain(tpg, tdt, rng)
    return records


def check_chain(tpg, tdt, rng):
    """CHAIN_CASE through ``patch_gram``: every block sums exactly
    MAX_CHAIN_TOKENS tokens in one tensor-core accumulator. Returns its
    error, rel to max|G|."""
    import numpy as np
    import torch
    shape, ks, pad, st = CHAIN_CASE
    x = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(tdt)
    n = shape[0] * shape[1] * shape[2]
    per_split = -(-n // patch_splits(tpg, x, ks, pad, st))
    if per_split != tpg.MAX_CHAIN_TOKENS:
        raise AssertionError(f"chain case: {per_split} tokens a split, not "
                             f"{tpg.MAX_CHAIN_TOKENS}")
    got = _launch_twice(tpg.patch_gram, x, ks, pad)
    want = tpg.patch_gram_plain(x, ks, pad, st)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"  patch_gram {tdt} {shape} chain cap: {per_split} tokens in each "
        f"block's accumulator, rel={rel:.3e}")
    if not (torch.isfinite(got).all() and rel <= GRAM_RTOL):
        raise AssertionError(f"chain case {tdt}: rel {rel:.3e} > {GRAM_RTOL}")
    return rel


def patch_splits(tpg, x, ks, pad, st):
    """The token split count the wrapper launches ``x`` with."""
    import torch
    b, h, w, c = x.shape
    pads = tpg.resolve_padding(pad, h, w, ks, st)
    ho, wo = tpg._out_shape(h, w, ks, pads, st)
    bf16 = x.dtype == torch.bfloat16
    slots = tpg._resident_blocks(x.device.index, tuple(st), bf16,
                                 tpg.gather_kind(x) == "vector")
    return tpg.plan_splits(b * ho * wo, tpg.block_tiles(c * ks[0] * ks[1],
                                                         bf16), slots)


def sym_splits(tsg, x):
    """(splits, tokens per split) the wrapper launches ``x`` with."""
    import torch
    bf16 = x.dtype == torch.bfloat16
    return tsg.split_plan(*x.shape, bf16,
                          tsg._resident_blocks(x.device.index, bf16))


def check_sym_case(tsg, x, dtype):
    """One sym_gram case: two launches and both variants bitwise equal, a
    bitwise symmetric result within SYM_RTOL of the plain version, and in
    f32 the pre-pass bit for bit its plain version. Returns the errors."""
    import torch
    n, f = x.shape
    if dtype == "f32" and not torch.equal(tsg.tf32_presplit(x),
                                          tsg.tf32_presplit_plain(x)):
        raise AssertionError(f"tf32_presplit ({n}, {f}): kernel differs "
                             "from its plain version")
    got = _launch_twice(tsg.sym_gram, x)
    if not torch.equal(got, tsg.sym_gram(x, variant="rect")):
        raise AssertionError("sym_gram: 'rect' differs from 'tri'")
    if not torch.equal(got, got.T):
        raise AssertionError(f"sym_gram ({n}, {f}): not symmetric")
    want = tsg.sym_gram_plain(x)
    abs_err = float((got - want).abs().max())
    rel = abs_err / max(float(want.abs().max()), 1.0)
    log(f"  sym_gram {dtype} ({n}, {f}): splits, tokens a split = "
        f"{sym_splits(tsg, x)} max_abs_err={abs_err:.3e} rel={rel:.3e}")
    if not (torch.isfinite(got).all() and rel <= SYM_RTOL):
        raise AssertionError(
            f"sym_gram {dtype} ({n}, {f}): kernel disagrees with its "
            f"plain version (rel {rel:.3e} > {SYM_RTOL})")
    return abs_err, rel


def check_sym_kernel(tsg, dtype):
    """sym_gram against its plain version on the card, in ``dtype``, on
    every case (check_sym_case) and, in f32, at the chain cap."""
    import numpy as np
    import torch
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(1)
    worst, main = 0.0, None
    for i, (n, f) in enumerate(SYM_CASES):
        if not tsg.sym_gram_supported(n, f):
            raise AssertionError(f"sym_gram ({n}, {f}) is below the gate")
        x = torch.from_numpy(rng.standard_normal((n, f)).astype(
            np.float32)).cuda().to(tdt)
        abs_err, rel = check_sym_case(tsg, x, dtype)
        worst = max(worst, rel)
        if i == 0:
            main = (x, abs_err, rel)
    x, abs_err, rel = main
    n, f = x.shape
    gather = {"f32": "pre-split swizzled slabs (tf32_presplit_kernel), "
                     "bulk copies",
              "bf16": "vector, features padded to 8" if f % 8 else "vector"}
    rec = _record(
        "sym_gram", dtype, x.shape, abs_err, rel, worst, len(SYM_CASES),
        gather=gather[dtype], splits=sym_splits(tsg, x)[0],
        ms=cuda_ms(lambda: tsg.sym_gram(x)),
        call=lambda: tsg.sym_gram(x),
        plain_ms=cuda_ms(lambda: tsg.sym_gram_plain(x)),
        **bounds(n * f * (f + 1), n * f * x.element_size() + f * f * 4,
                 dtype),
        **time_yardsticks(dtype, lambda: x))
    rec["chain_cap_rel_err"] = check_sym_chain(tsg, tdt, rng)
    return [rec]


def check_sym_chain(tsg, tdt, rng):
    """SYM_CHAIN_CASE through ``sym_gram``: every block sums exactly its
    chain cap of tokens (f32 MAX_CHAIN_TOKENS, flushing its tensor-core
    accumulator into an f32 total; bf16 BF16_CHAIN_TOKENS, unflushed).
    Returns its error, rel to max(max|G|, 1)."""
    import numpy as np
    import torch
    n, f = SYM_CHAIN_CASE
    bf16 = tdt == torch.bfloat16
    cap = tsg.BF16_CHAIN_TOKENS if bf16 else tsg.MAX_CHAIN_TOKENS
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(
        np.float32)).cuda().to(tdt)
    splits, per_split = sym_splits(tsg, x)
    if per_split != cap or splits * per_split != n:
        raise AssertionError(f"sym chain case: {splits} splits of "
                             f"{per_split} tokens, not of {cap}")
    return check_sym_case(tsg, x, "bf16" if bf16 else "f32")[1]


def sweep_sym_splits(tsg):
    """SPLIT_SWEEP through the f32 ``sym_gram``, each shape launched with
    one split and with the wave-filling count (the wrapper's plan
    replaced for the sweep): device ms of each (pre-pass, tile kernel and
    any reduce), every result checked against the plain version."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    plan, rows = tsg.split_plan, []
    slots = tsg._resident_blocks(0, False)
    try:
        for n, f in SPLIT_SWEEP:
            x = torch.from_numpy(rng.standard_normal((n, f)).astype(
                np.float32)).cuda()
            nt = -(-f // tsg.F32_TILE)
            tiles = nt * (nt + 1) // 2
            row = {"shape": [n, f], "block_tiles": tiles,
                   "waves": tiles / slots,
                   "wrapper_plan": list(plan(n, f, False, slots))}
            fill = max(tsg.split_count(n, tiles, slots),
                       -(-n // tsg.MAX_CHAIN_TOKENS))
            for key, splits in (("one", 1), ("fill", fill)):
                per = -(-(-(-n // splits)) // tsg.CHUNK) * tsg.CHUNK
                tsg.split_plan = lambda *_, p=per: (-(-n // p), p)
                want = tsg.sym_gram_plain(x)
                rel = float((tsg.sym_gram(x) - want).abs().max()) \
                    / max(float(want.abs().max()), 1.0)
                if rel > SYM_RTOL:
                    raise AssertionError(f"split sweep {n, f} {splits} "
                                         f"splits: rel {rel:.3e}")
                by_kernel = device_ms_by_kernel(lambda: tsg.sym_gram(x))
                row[key] = {"splits": -(-n // per), "tokens": per,
                            "device_ms": sum(by_kernel.values()),
                            "reduce_ms": sum(v for k, v in by_kernel.items()
                                             if "reduce_kernel" in k)}
            log(f"  split sweep {json.dumps(row)}")
            rows.append(row)
    finally:
        tsg.split_plan = plan
    return rows


def prob_stats(probs, labels, what):
    """Accuracy, ECE and NLL of [N, K] probabilities, after checking their
    shape, finiteness and sums."""
    import numpy as np
    from curvature_tpu_torch.eval import metrics
    if probs.shape != (2 * BATCH, CLASSES) or not np.isfinite(probs).all() \
            or np.abs(probs.sum(1) - 1).max() > 1e-3:
        raise AssertionError(f"{what} probabilities malformed")
    return {"acc": float(metrics.accuracy(probs, labels)),
            "ece": float(metrics.expected_calibration_error(probs,
                                                            labels)[0]),
            "nll": float(metrics.negative_log_likelihood(probs, labels))}


def laplace_tail(est, model, test_data, gen, counters, label,
                 damping=(ADD, MULTIPLY)):
    """An updated estimator's invert at ``damping`` -> SAMPLES-sample
    ensemble -> bnn eval on ``test_data``: every inverse-state tensor
    finite, no Gram kernel launched by the eval, the metrics printed.
    Returns the ensemble and the invert's seconds."""
    import torch
    from curvature_tpu_torch.eval import eval_bnn
    add, multiply = damping
    t0 = time.perf_counter()
    est.invert(add, multiply)
    torch.cuda.synchronize()
    invert_s = time.perf_counter() - t0
    check_finite(est.inv_state, f"{label} inv_state")
    t0 = time.perf_counter()
    ensemble = est.ensemble_params(SAMPLES, generator=gen)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    counters.reset()
    probs, labels, _ = eval_bnn(model, est, test_data, samples=SAMPLES,
                                ensemble_params=ensemble)
    if counters.read() != counters.zero():
        raise AssertionError(f"{label}: eval must not launch the Gram "
                             f"kernels: {counters.read()}")
    log(f"{label}: invert(add={add}, multiply={multiply}) {invert_s:.3f} s; "
        f"{SAMPLES}-sample ensemble {sample_s:.3f} s; bnn metrics (random "
        f"weights, {2 * BATCH} synthetic images) "
        f"{json.dumps(prob_stats(probs, labels, label))}")
    return ensemble, invert_s


def eval_rate(model, est, test_data, ensemble):
    """Images per second through ``eval_bnn`` with a given ensemble, best
    of 3 blocks."""
    import torch
    from curvature_tpu_torch.eval import eval_bnn
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eval_bnn(model, est, test_data, samples=SAMPLES,
                 ensemble_params=ensemble)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 2 * BATCH / best


def ladder(estimators, model, kfac, batches, test_data, gen, counters,
           block_layer=DENSE_LAYER, tag="ladder"):
    """The rest of the estimator ladder at full width, each through update
    (no Gram kernel launched), invert, a SAMPLES-sample ensemble and the
    bnn eval: Diagonal; EFB from the f32 KFAC path's factors (the
    eigendecomposition timed); INF as the pipeline builds it (EFB's free
    diags, the KFAC factors, EFB's lambdas and eigenvectors); and
    BlockDiagonal on ``block_layer``. ``tag`` prefixes the printed lines.
    Returns {kind: (estimator, ensemble)}."""
    import torch
    out = {}
    none = counters.zero()
    diag = estimators.Diagonal(model)
    drive_updates(diag, batches, gen, counters, f"{tag} diagonal", none)
    out["diagonal"] = (diag, laplace_tail(diag, model, test_data, gen,
                                          counters, f"{tag} diagonal",
                                          LADDER_DAMPING["diagonal"])[0])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    efb = estimators.EFB(model, kfac.state)
    torch.cuda.synchronize()
    shapes = sorted({tuple(f[k].shape) for f in kfac.state.values()
                     for k in "ag"})
    log(f"{tag} efb: eigendecomposition of {2 * len(efb.metas)} KFAC "
        f"factors ({len(shapes)} distinct shapes, the largest "
        f"{max(shapes, key=math.prod)}) in "
        f"{time.perf_counter() - t0:.3f} s")
    drive_updates(efb, batches, gen, counters, f"{tag} efb", none)
    out["efb"] = (efb, laplace_tail(efb, model, test_data, gen, counters,
                                    f"{tag} efb", LADDER_DAMPING["efb"])[0])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counters.reset()
    inf = estimators.INF(model, efb.diags, kfac.state, efb.state,
                         eigvecs=efb.eigvecs)
    inf.update(rank=INF_RANK, max_product=INF_MAX_PRODUCT,
               bucket=INF_BUCKET)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if counters.read() != none:
        raise AssertionError(f"INF build launched {counters.read()}")
    sizes = {n: [s["ua"].shape[-1], s["ug"].shape[-1]]
             for n, s in inf.state.items()}
    r = [lm[0] * lm[1] for lm in sizes.values()]
    log(f"{tag} inf: update(rank={INF_RANK}, max_product="
        f"{INF_MAX_PRODUCT}, bucket={INF_BUCKET}) in {build_s:.3f} s; R = "
        f"L*M from {min(r)} to {max(r)}, sum {sum(r)}; (L, M) by layer "
        f"{json.dumps(sizes)}")
    check_finite(inf.state, f"{tag} inf state")
    out["inf"] = (inf, laplace_tail(inf, model, test_data, gen, counters,
                                    f"{tag} inf", LADDER_DAMPING["inf"])[0])

    blk = estimators.BlockDiagonal(model, layer_filter=block_layer)
    drive_updates(blk, batches, gen, counters, f"{tag} block "
                  f"({block_layer})", none)
    out["block"] = (blk, laplace_tail(blk, model, test_data, gen, counters,
                                      f"{tag} block ({block_layer})",
                                      LADDER_DAMPING["block"])[0])
    return out


def dense_check(estimators, model, batches, gen, name=DENSE_LAYER):
    """All five estimators built on layer ``name`` alone and updated from
    ``batches``, each against its damped precision P formed densely in
    float64 on the card (flat order: the [out, cols] matrix view's rows):
    ``precision_solve`` against ``torch.linalg.solve(P, d)`` (relative to
    max |P^-1 d|), ``quadratic_form`` against d^T P d and
    ``logdet_precision`` against ``slogdet(P)``. A grouped conv's KFAC,
    EFB and INF precisions are block-diagonal over its g groups (rows
    group-major), formed here as ``block_diag`` of the per-group dense
    blocks, and their solve of an offset held in group 0 alone must be
    exactly zero in every other group (Diagonal's too; Block is the
    layer's whole Fisher). The estimators run in float64 and in float32;
    each reading is held to ``dense_bars`` at the unit roundoff of the
    estimator's dtype, and a miss raises."""
    import torch
    from curvature_tpu_torch.estimators.block import _flatten_grad
    from curvature_tpu_torch.ops.linalg import kron, sym
    a, m = ADD, MULTIPLY
    for dtype in (torch.float64, torch.float32):
        kw = {"layer_filter": name, "dtype": dtype}
        est = {"kfac": estimators.KFAC(model, **kw),
               "diagonal": estimators.Diagonal(model, **kw),
               "block": estimators.BlockDiagonal(model, **kw)}
        for e in est.values():
            for x in batches:
                e.update(x, generator=gen)
        est["efb"] = estimators.EFB(model, est["kfac"].state, **kw)
        for x in batches:
            est["efb"].update(x, generator=gen)
        est["inf"] = estimators.INF(model, est["efb"].diags,
                                    est["kfac"].state, est["efb"].state,
                                    eigvecs=est["efb"].eigvecs, **kw)
        est["inf"].update(rank=INF_RANK, max_product=INF_MAX_PRODUCT,
                          bucket=INF_BUCKET)
        meta = est["kfac"].metas[name]
        out_f, cols, g = meta.out_features, meta.mat_cols, meta.groups
        og = out_f // g
        dev = est["kfac"].device

        def eye(k):
            return torch.eye(k, dtype=torch.float64, device=dev)

        def state(kind):
            return est[kind].state[name].double()

        def per_group(t, *shape):
            """A state tensor as its [g, *shape] group blocks (a plain
            layer is one group)."""
            return t.double().reshape((g,) + shape)
        fac = est["kfac"].state[name]
        fa, fg = per_group(fac["a"], cols, cols), per_group(fac["g"], og, og)
        ev = est["efb"].eigvecs[name]
        ua, ug = per_group(ev["a"], cols, cols), per_group(ev["g"], og, og)
        u = torch.block_diag(*[kron(ug[j], ua[j]) for j in range(g)])
        s = est["inf"].state[name]
        va = per_group(s["ua"], cols, s["ua"].shape[-1])
        vg = per_group(s["ug"], og, s["ug"].shape[-1])
        lam, corr = per_group(s["lam"], -1), per_group(s["corr"], -1)
        # INF's [cols, og] flat order per group, to the [og, cols] view's
        idx = torch.arange(og * cols, device=dev)
        perm = idx.reshape(cols, og).T.reshape(-1)
        v = [kron(va[j], vg[j]) for j in range(g)]
        p_inf = [(torch.diag(m * corr[j].clamp_min(0) + a)
                  + (v[j] * (m * lam[j])) @ v[j].T)[perm][:, perm]
                 for j in range(g)]
        idx = torch.arange(out_f * cols, device=dev)
        # Block's torch view(-1) order (weights, then the bias)
        perm_b = torch.argsort(_flatten_grad(idx.reshape(out_f, cols),
                                             meta.has_bias))
        dense = {
            "kfac": torch.block_diag(*[
                kron(m ** 0.5 * fg[j] + a ** 0.5 * eye(og),
                     m ** 0.5 * fa[j] + a ** 0.5 * eye(cols))
                for j in range(g)]),
            "diagonal": torch.diag((m * state("diagonal") + a).reshape(-1)),
            "block": (m * state("block")
                      + a * eye(out_f * cols))[perm_b][:, perm_b],
            "efb": (u * (m * state("efb") + a).reshape(-1)) @ u.T,
            "inf": torch.block_diag(*p_inf),
        }
        basis = {"efb": u, "inf": torch.block_diag(*v)}
        misses = []
        d = torch.randn((out_f, cols),
                        generator=torch.Generator().manual_seed(3)).to(dev)
        dv = d.double().reshape(-1)
        for kind, e in est.items():
            p = sym(dense[kind])
            evals = torch.linalg.eigvalsh(p)
            want = torch.linalg.solve(p, dv)
            got = e.precision_solve({name: d}, a, m)[name].double()
            got = got.reshape(-1)
            quad = float(dv @ p @ dv)
            sign, logdet = torch.linalg.slogdet(p)
            errs = {
                "solve": float((got - want).abs().max() / want.abs().max()),
                "quad": abs(e.quadratic_form({name: d}, a, m) - quad) / quad,
                "logdet": abs(e.logdet_precision(a, m) - float(logdet))
                / abs(float(logdet))}
            errs["basis"], bars = dense_bars(dtype, evals, basis.get(kind),
                                             max(og, cols))
            if g > 1 and kind != "block":
                # an offset in group 0 alone moves no other group
                d0 = torch.zeros_like(d)
                d0[:og] = d[:og]
                leak = e.precision_solve({name: d0}, a, m)[name][og:]
                errs["cross_group"], bars["cross_group"] = \
                    float(leak.abs().max()), 0.0
            log(f"dense check {kind} {str(dtype)[6:]} ({name}, {g} groups, "
                f"P {tuple(p.shape)} float64, cond "
                f"{float(evals[-1] / evals[0]):.3e}): " + ", ".join(
                    f"{k} {x:.3e} (bar {bars[k]:.3e})"
                    for k, x in errs.items()))
            if float(sign) <= 0 or any(errs[k] > bars[k] for k in errs):
                misses.append(f"{kind} {dtype}: {errs} over {bars}")
        if misses:                     # every reading printed first
            raise AssertionError("dense check: " + "; ".join(misses))


def dense_bars(dtype, evals, basis, dim):
    """The dense check's bars for one estimator in ``dtype`` (unit
    roundoff eps = 2^-24 in float32, 2^-53 in float64), C = DENSE_C,
    n = dim P, from P's float64 eigenvalues ``evals``. ``basis`` is the
    basis U that EFB (its Kronecker eigenvectors) and INF (its low-rank
    columns of them) treat as orthonormal, None for the others; its
    departure delta = ||U^T U - I||_2 is measured and enters the bars:

    - basis: delta <= 2 C dim eps, the bound of an ``eigh`` of order
      ``dim`` for each of the two Kronecker factors;
    - solve: C cond(P) eps + 2 (1 + cond(P)) delta, the backward-stable
      bound plus first order in delta (U^-1 = (I - E) U^T);
    - quad: C log2(n) eps, a pairwise sum of n terms;
    - logdet: (C (sqrt(n) eps + n 2^-53) sum|log lambda_i|
      + 2 |logdet U^T U|) / |logdet P|: n rounded logs, the float64
      factorization of order n behind ``slogdet(P)``, and
      det(U D U^T) = det D det(U^T U).

    Returns (delta, {what: bar})."""
    import torch
    eps = torch.finfo(dtype).eps / 2
    eps64 = torch.finfo(torch.float64).eps / 2
    n = evals.shape[0]
    delta = ldu = 0.0
    if basis is not None:
        utu = basis.T @ basis
        delta = float(torch.linalg.eigvalsh(
            utu - torch.eye(utu.shape[0], dtype=utu.dtype,
                            device=utu.device)).abs().max())
        ldu = abs(float(torch.linalg.slogdet(utu)[1]))
    logs = torch.log(evals)
    cond = float(evals[-1] / evals[0])
    return delta, {
        "solve": DENSE_C * cond * eps + 2 * (1 + cond) * delta,
        "quad": DENSE_C * math.log2(n) * eps,
        "logdet": (DENSE_C * (math.sqrt(n) * eps + n * eps64)
                   * float(logs.abs().sum()) + 2 * ldu)
        / abs(float(logs.sum())),
        "basis": 2 * DENSE_C * dim * eps}


class Counters:
    """The kernel wrappers' launch counters, as {name: (wrapper,
    attribute)}."""

    def __init__(self, tpg, tsg):
        self.fns = {"patch_gram_tiled": (tpg.patch_gram_tiled, "launches"),
                    "patch_gram_v2": (tpg.patch_gram_v2, "launches"),
                    "patch_gram_v2_any_stride": (tpg.patch_gram_v2,
                                                 "any_stride_launches"),
                    "patch_gram": (tpg.patch_gram, "launches"),
                    "sym_gram": (tsg.sym_gram, "launches"),
                    "tf32_presplit": (tsg.tf32_presplit, "launches")}

    def reset(self):
        for fn, attr in self.fns.values():
            setattr(fn, attr, 0)

    def read(self):
        return {name: getattr(fn, attr)
                for name, (fn, attr) in self.fns.items()}

    def zero(self):
        return {name: 0 for name in self.fns}


def nchw_batches(rng, n_batches, batch, dev, size=None):
    import numpy as np
    import torch
    xs, ys = synthetic(rng, n_batches * batch, size)
    return [(torch.from_numpy(np.ascontiguousarray(
        xs[i * batch:(i + 1) * batch].transpose(0, 3, 1, 2))).to(dev)
        .contiguous(memory_format=torch.channels_last),
        ys[i * batch:(i + 1) * batch]) for i in range(n_batches)]


def synthetic(rng, num, size=None):
    """``num`` synthetic NHWC images of ``size`` (default SIZE) squared."""
    from curvature_tpu_torch.data import synthetic_images
    size = size or SIZE
    return synthetic_images(rng, num, size, size, 3, CLASSES)


def drive_updates(est, batches, gen, counters, path, expect):
    """The path's updates with the counters set to 0 just before and read
    just after; ``expect`` is the exact launch count of each kernel."""
    import torch
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in batches:
        est.update(x, generator=gen, num_samples=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counters.read()
    log(f"{path}: {len(batches)} updates in {seconds:.3f} s (first block, "
        f"incl. warm-up); launches {json.dumps(got)}")
    if got != expect:
        raise AssertionError(f"{path}: expected launches {expect}, got {got}")
    check_finite(est.state, f"{path} state")
    return got


def check_finite(tree, what):
    """Raises unless every tensor of a nested dict is finite."""
    import torch
    for key, t in tree.items():
        if isinstance(t, dict):
            check_finite(t, f"{what}.{key}")
        elif not torch.isfinite(t).all():
            raise AssertionError(f"{what}.{key} is not finite")


def best_rate(est, batches, gen, batch):
    """Images per second through ``update``, best of 3 blocks, each ended
    by a synchronize."""
    import torch
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in batches:
            est.update(x, generator=gen, num_samples=1)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return batch * len(batches) / best


def a_factor_check(est, plain_est, x, name, what, route=None):
    """One layer's A factor from ``est`` (kernel route) against
    ``plain_est`` (``use_kernels=False``) on the same capture; ``route``,
    where given, is the route ``est`` must take for it."""
    import torch
    cap = est.capture(x, labels=torch.zeros(x.shape[0], dtype=torch.long,
                                            device=x.device))
    meta, act = plain_est.metas[name], cap.acts[name]
    if route is not None:
        took = est.a_route(est.metas[name], act.shape, act.element_size())
        if took != route:
            raise AssertionError(f"{name} ({what}): route {took}, "
                                 f"want {route}")
    got = est._a_factor(meta, act)
    want = plain_est._a_factor(meta, act)
    rel = float((got - want).abs().max() / want.abs().max())
    log(f"A factor {name} ({what}) kernel vs use_kernels=False: "
        f"rel {rel:.3e}")
    if rel > GRAM_RTOL:
        raise AssertionError(f"{name} ({what}): A factor rel err {rel:.3e}")


def run_cli(module, argv, counters, smi, label):
    """``module.main(argv)`` in-process with the launch counters set to 0
    just before and read just after; prints its wall seconds. Returns
    (result, launches)."""
    import torch
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = module.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = counters.read()
    log(f"pipeline {label}: {seconds:.3f} s wall; launches {json.dumps(got)}"
        f" ({smi})")
    return out, got


def pipelines(estimators, counters, smi):
    """The pipeline CLIs (``factors`` -> ``evaluate``) in-process, LeNet-5
    on the bundled digits and ResNet-18 on synthetic data; every result
    checked. Returns the ResNet-18 factors runs' launches by path, and
    (path, estimator, batch) of each for ``--profile``."""
    import os
    import numpy as np
    import torch
    from curvature_tpu_torch.data.loaders import FIXTURE_DIR
    from curvature_tpu_torch.pipelines import common, evaluate, factors
    from curvature_tpu_torch.utils.checkpoint import results_paths
    from curvature_tpu_torch.utils.config import parse_args
    none = counters.zero()
    root = os.path.abspath(os.path.join(PIPE_ROOT, "lenet5"))
    base = LENET_ARGV + ["--data_dir", FIXTURE_DIR, "--root_dir", root,
                         "--results_dir", root]
    # (a) LeNet-5 on the digits: no Gram kernel (C < 32, no corr route)
    for name in ("diag", "kfac", "efb"):
        est, got = run_cli(factors, base + ["--estimator", name], counters,
                           smi, f"lenet5 factors {name}")
        if got != none or est.num_updates != LENET_UPDATES:
            raise AssertionError(f"lenet5 factors {name}: launches {got}, "
                                 f"{est.num_updates} updates")
        check_finite(est.state, f"lenet5 {name} state")
    est, _ = run_cli(factors, base + ["--estimator", "inf", "--rank", "100"],
                     counters, smi, "lenet5 factors inf (rank 100)")
    check_finite(est.state, "lenet5 inf state")
    kfac_argv = base + ["--estimator", "kfac"] + BLITZ
    (probs, labels), _ = run_cli(evaluate, kfac_argv, counters, smi,
                                 "lenet5 evaluate kfac (test)")
    nn = evaluate.summary(probs, labels)
    (stats, bnn_stats), got = run_cli(evaluate, kfac_argv + ["--fgsm"]
                                      + FGSM_CHAIN_SAMPLES, counters, smi,
                                      "lenet5 evaluate kfac --fgsm")
    if got != none:
        raise AssertionError(f"lenet5 evaluate launched {got}")
    # epsilon 0 leaves the batch as it is: the sweep's first row is the
    # plain Bayesian eval
    log(f"lenet5 digits kfac (bundled weights, {len(labels)} test digits):"
        f" NN accuracy {nn[0]:.2f}% ECE {100 * nn[1]:.2f}% NLL "
        f"{nn[2]:.4f}; BNN ({FGSM_CHAIN_SAMPLES[1]} samples, norm 1, scale "
        f"5e4) accuracy "
        f"{bnn_stats['acc'][0]:.2f}% ECE {bnn_stats['ece1'][0]:.2f}% NLL "
        f"{bnn_stats['nll'][0]:.4f}; FGSM eps 0.1: NN {stats['acc'][5]:.2f}%"
        f", BNN {bnn_stats['acc'][5]:.2f}%")
    if abs(stats["acc"][0] - nn[0]) > 1e-6 or nn[0] <= 50.0 \
            or bnn_stats["acc"][0] <= 50.0 \
            or not np.isfinite([v for k in stats for v in stats[k]]).all() \
            or not np.isfinite([v for k in bnn_stats
                                for v in bnn_stats[k]]).all():
        raise AssertionError(f"lenet5 evaluate: NN {nn}, FGSM {stats}, "
                             f"BNN {bnn_stats}")

    # (b) ResNet-18 on synthetic data, f32 then bf16
    by_path, updated = {}, []
    root = os.path.abspath(os.path.join(PIPE_ROOT, "resnet18"))
    base = R18_ARGV + ["--root_dir", root, "--results_dir", root]
    for path, extra in zip(R18_PATHS, ([], ["--precision", "bfloat16",
                                            "--suffix", "_bf16"])):
        est, got = run_cli(factors, base + ["--estimator", "kfac"] + extra,
                           counters, smi, f"resnet18 factors kfac {path}")
        cfg = parse_args(base + extra)
        x = next(common.on_device(common.build_data(cfg, "train"),
                                  est.device))[0]
        per_update = R18_ROUTES[path]
        want = dict(none, **{f"patch_gram_{r}": n * R18_UPDATES
                             for r, n in per_update.items()})
        log(f"{path}: per update {json.dumps(per_update)} by JAX's routes")
        if got != want or est.num_updates != R18_UPDATES:
            raise AssertionError(f"{path}: launches {got}, want {want}")
        check_finite(est.state, f"{path} state")
        by_path[path] = got
        updated.append((path, est, x))
        dtype = {"compute_dtype": torch.bfloat16} if extra else {}
        for layer, route in R18_CHECKED.items():
            if extra and route != "v2":            # patches in bf16
                continue
            a_factor_check(est, estimators.KFAC(
                est.model, use_kernels=False, layer_filter=[layer],
                **dtype), x, layer, f"resnet18 {route} s"
                f"{est.metas[layer].strides[0]}, {path}", route)
    for name in ("efb", "diag"):
        est, got = run_cli(factors, base + ["--estimator", name], counters,
                           smi, f"resnet18 factors {name}")
        if got != none:
            raise AssertionError(f"resnet18 {name} launched {got}")
        check_finite(est.state, f"resnet18 {name} state")
    est, _ = run_cli(factors, base + ["--estimator", "inf", "--rank", "100"],
                     counters, smi, "resnet18 factors inf (rank 100)")
    check_finite(est.state, "resnet18 inf state")
    for name in ("kfac", "efb"):
        argv = base + ["--estimator", name, "--ood"] + R18_DAMPING
        (probs, bnn_probs, labels), got = run_cli(
            evaluate, argv, counters, smi, f"resnet18 evaluate {name} --ood")
        with np.load(results_paths(parse_args(argv))[0] + ".npz",
                     allow_pickle=True) as f:
            auroc = f["auroc"]
            ood = f["bnn_ood_predictions"]
        for what, p in (("nn", probs), ("bnn", bnn_probs),
                        ("bnn ood", ood)):
            if p.shape != (256, 10) or not np.isfinite(p).all() \
                    or np.abs(p.sum(1) - 1).max() > 1e-3:
                raise AssertionError(f"resnet18 {name} {what} predictions "
                                     "malformed")
        log(f"resnet18 synthetic {name} --ood (random weights): NN "
            f"accuracy {100 * np.mean(probs.argmax(1) == labels):.2f}%, BNN "
            f"{100 * np.mean(bnn_probs.argmax(1) == labels):.2f}%; AUROC NN "
            f"{auroc[0]:.4f} BNN {auroc[1]:.4f}")
        if got != none or not np.isfinite(auroc).all():
            raise AssertionError(f"resnet18 evaluate {name}: launches {got},"
                                 f" AUROC {auroc}")
    return by_path, updated


def hyper_run(hyper, argv, counters, smi, label):
    """One ``hyper`` CLI through :func:`run_cli`: no Gram kernel launched
    (JAX has none there either), a finite best cost; prints the seconds per
    candidate. Returns (result, wall seconds, candidates)."""
    import numpy as np
    (out, got), seconds = timed(lambda: run_cli(hyper, argv, counters, smi,
                                                label))
    rows = 1 if "grad" in argv else len(out["stats"]["cost"])
    if got != counters.zero() or not np.isfinite(out["best_cost"]):
        raise AssertionError(f"{label}: launches {got}, best cost "
                             f"{out['best_cost']}")
    log(f"{label}: best cost {out['best_cost']:.4f} over {rows} candidates,"
        f" {out['penalized']} penalized; {seconds / rows:.4f} s per "
        f"candidate ({smi})")
    return out, seconds, rows


def hyper_inputs(estimators, models, counters, smi, dev):
    """What ``--hyper`` runs the phase on: the factor files the pipeline
    phase writes (LeNet-5 diag, kfac, efb; ResNet-18 kfac, efb) and
    ResNet-50's f32 KFAC after UPDATES updates. Returns (model, estimator,
    test batches)."""
    import os
    import numpy as np
    import torch
    from curvature_tpu_torch.data.loaders import FIXTURE_DIR
    from curvature_tpu_torch.pipelines import factors
    root = os.path.abspath(os.path.join(PIPE_ROOT, "lenet5"))
    base = LENET_ARGV + ["--data_dir", FIXTURE_DIR, "--root_dir", root,
                         "--results_dir", root]
    for name in ("diag", "kfac", "efb"):
        run_cli(factors, base + ["--estimator", name], counters, smi,
                f"lenet5 factors {name}")
    root = os.path.abspath(os.path.join(PIPE_ROOT, "resnet18"))
    base = R18_ARGV + ["--root_dir", root, "--results_dir", root]
    for name in ("kfac", "efb"):
        run_cli(factors, base + ["--estimator", name], counters, smi,
                f"resnet18 factors {name}")
    model = models.resnet50(num_classes=CLASSES, device=dev)
    models.load_jax_variables(model, models.seeded_variables(model, 0))
    model = model.to(memory_format=torch.channels_last)
    rng = np.random.default_rng(1)
    batches = [x for x, _ in nchw_batches(rng, UPDATES, BATCH, dev)]
    test_data = nchw_batches(rng, 2, BATCH, dev)
    est = estimators.KFAC(model)
    gen = torch.Generator(device=dev).manual_seed(2)
    for x in batches:
        est.update(x, generator=gen, num_samples=1)
    return model, est, test_data


def hyper_phase(counters, smi, dev, r50=None):
    """The damping search and the predictives (JAX pipelines/hyper.py,
    eval/{predictive,marglik,calibrate,predictor}.py, laplace.py), on the
    factor files of the pipeline phase under ``PIPE_ROOT``: (a) LeNet-5 on
    the digits, the trained cell: every optimizer, ``--layer``, the
    evidence by gp and by gradient ascent, then ``evaluate`` at the
    searched damping (BNN accuracy > 50%) and the closed-form,
    linearized, predictor, facade and temperature paths; (b) ResNet-18 at
    full width: sampled and evidence searches, ``evaluate --ood`` with
    every closed-form and linearized predictive, the predictives' rates;
    (c) with ``r50`` = (model, KFAC estimator, test batches), ResNet-50:
    the batched evaluator and the evidence. No search, eval or evaluate
    launches a Gram kernel. Prints the seconds per candidate."""
    import os
    import shutil
    import numpy as np
    import torch
    from curvature_tpu_torch import laplace
    from curvature_tpu_torch.data.loaders import FIXTURE_DIR
    from curvature_tpu_torch.eval import (
        BayesianPredictor, eval_bnn, eval_bnn_closed_form,
        eval_bnn_linearized, eval_nn_temperature, metrics)
    from curvature_tpu_torch.eval.calibrate import (
        collect_logits, temperature_scale)
    from curvature_tpu_torch.eval.marglik import (
        dataset_map_nll, log_marginal_likelihood, marglik_gradient_tune)
    from curvature_tpu_torch.pipelines import (
        common, evaluate, hyper, surrogates)
    from curvature_tpu_torch.utils.checkpoint import results_paths
    from curvature_tpu_torch.utils.config import parse_args
    t_phase = time.perf_counter()
    none = counters.zero()

    def quiet(fn):
        """``fn()`` with no Gram kernel launched."""
        counters.reset()
        out = fn()
        if counters.read() != none:
            raise AssertionError(f"launches {counters.read()}")
        return out

    def acc(p, y):
        return float(metrics.accuracy(p, y))

    # (a) LeNet-5 on the bundled digits
    root = os.path.abspath(os.path.join(PIPE_ROOT, "lenet5"))
    results = os.path.join(root, "hyper")
    shutil.rmtree(results, ignore_errors=True)
    base = LENET_ARGV + ["--data_dir", FIXTURE_DIR, "--root_dir", root,
                         "--results_dir", results]
    for est_name, flags in HYPER_LENET:
        hyper_run(hyper, base + ["--estimator", est_name] + flags, counters,
                  smi, f"lenet5 hyper {est_name} {' '.join(flags)}")
    marg = base + ["--estimator", "kfac", "--objective", "marglik",
                   "--results_dir", os.path.join(root, "hyper_marglik")]
    for flags in HYPER_LENET_MARGLIK:
        out, seconds, _ = hyper_run(hyper, marg + flags, counters, smi,
                                    f"lenet5 hyper kfac marglik "
                                    f"{' '.join(flags)}")
        if "grad" in flags:
            log(f"  {seconds * 1e3 / len(out['trace']):.2f} ms per Adam "
                f"step (incl. the NLL pass and the factor load)")
    kfac_argv = base + ["--estimator", "kfac"]
    cfg = parse_args(kfac_argv)
    best = np.load(results_paths(cfg)[0] + "_best_params.npy")
    (stats, bnn_stats), got = run_cli(evaluate, kfac_argv + ["--fgsm"]
                                      + FGSM_CHAIN_SAMPLES, counters, smi,
                                      "lenet5 evaluate kfac --fgsm at the "
                                      "searched damping")
    model = common.build_model(cfg)
    val = list(common.on_device(common.build_data(cfg, splits="val"), dev))
    test = list(common.on_device(common.build_data(cfg, splits="test"),
                                 dev))
    est = evaluate.load_estimator(cfg, model)
    ev = hyper.make_batched_evaluator(cfg, model, est, val)
    at_best, at_blitz = quiet(lambda: ev(
        [best[0], float(BLITZ[1])], [best[1], float(BLITZ[3])],
        torch.Generator(device=dev).manual_seed(cfg.seed)))
    log(f"lenet5 kfac val cost ({SAMPLES} samples): searched damping "
        f"(norm {np.ravel(best[0])[0]:.4g}, scale "
        f"{np.ravel(best[1])[0]:.4g}) {at_best['cost']:.3f} "
        f"(acc {at_best['acc']:.2f}%, ECE {at_best['ece']:.2f}%) vs blitz's"
        f" (1, 5e4) {at_blitz['cost']:.3f} (acc {at_blitz['acc']:.2f}%, "
        f"ECE {at_blitz['ece']:.2f}%); test BNN accuracy at the searched "
        f"damping {bnn_stats['acc'][0]:.2f}%")
    if got != none or bnn_stats["acc"][0] <= 50.0:
        raise AssertionError(f"lenet5 evaluate at the searched damping: "
                             f"launches {got}, BNN {bnn_stats['acc'][0]}")
    evaluate.invert_from_config(cfg, est, results_paths(cfg)[0])
    gen = torch.Generator(device=dev).manual_seed(3)
    ens = est.ensemble_params(SAMPLES, generator=gen)
    preds = {}
    for m in ("probit", "bridge"):
        preds[m] = quiet(lambda: eval_bnn_closed_form(
            model, est, test, ensemble_params=ens, method=m))
    for m in ("mc", "probit"):
        preds[f"linearized_{m}"] = quiet(lambda: eval_bnn_linearized(
            model, est, test, ensemble_params=ens, method=m))
    line = {k: round(acc(p, y), 2) for k, (p, y) in preds.items()}
    log(f"lenet5 kfac predictives at the searched damping, test accuracy "
        f"(%): {json.dumps(line)}")
    if min(line.values()) <= 50.0:
        raise AssertionError(f"lenet5 predictives: {line}")
    x0, y0 = test[0]
    pred = quiet(lambda: BayesianPredictor(model, est, ensemble_params=ens))
    out = quiet(lambda: (pred(x0), pred.predict_closed_form(x0, "bridge"),
                         pred.predict_linearized(x0)))
    for o in out:
        if o.mean.shape != (len(y0), 10) or not all(
                torch.isfinite(t).all() for t in o):
            raise AssertionError("lenet5 BayesianPredictor malformed")
    la = quiet(lambda: laplace.fit(model, val[:4], "kfac", mc_samples=1,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(4)))
    tuned = quiet(lambda: la.optimize_prior_precision())
    p_lin = quiet(lambda: la.predictive(x0, method="linearized"))
    log(f"lenet5 laplace.fit kfac -> optimize_prior_precision (200 steps): "
        f"norm {tuned['norms'][0]:.4g}, scale {tuned['scales'][0]:.4g}, "
        f"log evidence {tuned['log_marglik']:.2f}; linearized predictive "
        f"accuracy on a test batch {acc(p_lin, y0):.2f}%; predictor BALD "
        f"{float(out[0].epistemic.mean()):.4f}")
    if p_lin.shape != (len(y0), 10) or not np.isfinite(p_lin).all() \
            or np.abs(p_lin.sum(1) - 1).max() > 1e-3:
        raise AssertionError("lenet5 laplace facade predictions malformed")
    probs_t, _, temp = quiet(lambda: eval_nn_temperature(model, val, test))
    v_logits, v_labels = collect_logits(model, val)

    def v_nll(t):
        p = temperature_scale(v_logits, t)
        return float(-np.mean(np.log(p[np.arange(len(v_labels)),
                                       v_labels])))
    log(f"lenet5 temperature scaling: T {temp:.4f}, val NLL {v_nll(temp):.4f}"
        f" (T=1: {v_nll(1.0):.4f}), test accuracy "
        f"{acc(probs_t, np.concatenate([y for _, y in test])):.2f}%")
    if not np.isfinite(temp) or v_nll(temp) > v_nll(1.0):
        raise AssertionError(f"temperature {temp}")
    xs = np.random.default_rng(0).uniform(-10, 10, (11, 2))
    ys = np.sin(xs[:, 0]) + xs[:, 1]
    cand = np.random.default_rng(1).uniform(-10, 10, (512, 2))
    t0 = time.perf_counter()
    for _ in range(10):
        surrogates.GaussianProcess().fit(xs, ys).predict(cand,
                                                         return_std=True)
    log(f"gp surrogate fit (11 points) + 512-candidate proposal: "
        f"{(time.perf_counter() - t0) * 100:.2f} ms (host)")

    # (b) ResNet-18 at full width on synthetic data
    root = os.path.abspath(os.path.join(PIPE_ROOT, "resnet18"))
    results = os.path.join(root, "hyper")
    shutil.rmtree(results, ignore_errors=True)
    base = R18_ARGV + ["--root_dir", root, "--results_dir", results]
    for est_name in ("kfac", "efb"):
        hyper_run(hyper, base + ["--estimator", est_name] + HYPER_R18,
                  counters, smi, f"resnet18 hyper {est_name} "
                  f"{' '.join(HYPER_R18)}")
    for flags in HYPER_R18_MARGLIK:
        out, seconds, _ = hyper_run(
            hyper, base + ["--estimator", "kfac", "--objective", "marglik"]
            + flags, counters, smi,
            f"resnet18 hyper kfac marglik {' '.join(flags)}")
    cfg = parse_args(base + ["--estimator", "kfac"])
    model = common.build_model(cfg)
    est = evaluate.load_estimator(cfg, model)
    train = list(common.on_device(common.build_data(cfg, "train"), dev))
    nll = quiet(lambda: dataset_map_nll(model, train))
    (_, seconds) = timed(lambda: quiet(lambda: marglik_gradient_tune(
        est, nll, steps=20)))
    log(f"resnet18 kfac evidence gradient ascent: {seconds * 50:.2f} ms per "
        f"Adam step (20 steps; every factor Cholesky-factored, up to "
        f"4,609^2, and differentiated; {smi})")
    for kind in HYPER_PREDICTIVES:
        argv = base + ["--estimator", "kfac", "--ood", "--predictive",
                       kind] + R18_DAMPING + HYPER_PREDICTIVE_SAMPLES
        (probs, bnn_probs, labels), got = run_cli(
            evaluate, argv, counters, smi,
            f"resnet18 evaluate kfac --ood --predictive {kind}")
        with np.load(results_paths(parse_args(argv))[0] + ".npz",
                     allow_pickle=True) as f:
            auroc = f["auroc"]
            ood = f["bnn_ood_predictions"]
        for what, p in (("bnn", bnn_probs), ("bnn ood", ood)):
            if p.shape != (256, 10) or not np.isfinite(p).all() \
                    or np.abs(p.sum(1) - 1).max() > 1e-3:
                raise AssertionError(f"resnet18 {kind} {what} predictions "
                                     "malformed")
        log(f"resnet18 --predictive {kind} (random weights): BNN accuracy "
            f"{acc(bnn_probs, labels):.2f}%; AUROC NN {auroc[0]:.4f} BNN "
            f"{auroc[1]:.4f}")
        if got != none or not np.isfinite(auroc).all():
            raise AssertionError(f"resnet18 --predictive {kind}: launches "
                                 f"{got}, AUROC {auroc}")
    est.invert(*(float(v) for v in R18_DAMPING[1::2]))
    test = list(common.on_device(common.build_data(cfg, "test"), dev))
    ens = est.ensemble_params(SAMPLES, generator=torch.Generator(
        device=dev).manual_seed(5))
    rates = {}
    for name, fn in (
            ("sampled", lambda: eval_bnn(model, est, test, SAMPLES,
                                         ensemble_params=ens)),
            ("probit", lambda: eval_bnn_closed_form(
                model, est, test, ensemble_params=ens)),
            ("linearized", lambda: eval_bnn_linearized(
                model, est, test, ensemble_params=ens))):
        quiet(fn)                                      # warm-up
        rates[name] = round(256 / timed(fn)[1], 2)
    log(f"resnet18 predictive rates, img/s ({SAMPLES}-sample ensemble, 256 "
        f"images, after a warm-up run; {smi}): {json.dumps(rates)}")
    del est, ens, model

    # (c) ResNet-50 at 224², the main path's f32 KFAC factors
    if r50 is not None:
        model, est, test_data = r50
        cfg = parse_args(["--samples", str(HYPER_R50_SAMPLES)])
        ev = hyper.make_batched_evaluator(cfg, model, est, test_data)
        res, seconds = timed(lambda: quiet(lambda: ev(
            *HYPER_R50_CANDIDATES,
            torch.Generator(device=dev).manual_seed(6))))
        log(f"resnet50 batched evaluator: {len(res)} candidates x "
            f"{HYPER_R50_SAMPLES} samples x {2 * BATCH} images, "
            f"{seconds / len(res):.3f} s per candidate, {ev.penalized} "
            f"penalized ({smi}); costs "
            f"{[round(r['cost'], 3) for r in res]}")
        if ev.penalized == len(res):
            raise AssertionError("resnet50: every candidate penalized")
        nll = quiet(lambda: dataset_map_nll(model, test_data))
        evid, pen = [], 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a, b in HYPER_R50_EVIDENCE:
            try:
                evid.append(round(quiet(lambda: log_marginal_likelihood(
                    est, nll, a, b)), 1))
            except torch.linalg.LinAlgError:
                evid.append(None)
                pen += 1
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        log(f"resnet50 evidence at {len(evid)} candidates: "
            f"{seconds / len(evid):.3f} s per candidate, {pen} singular "
            f"({smi}); {evid}")
        if pen == len(evid):
            raise AssertionError("resnet50: every evidence singular")
    log(f"hyper phase: {time.perf_counter() - t_phase:.1f} s wall ({smi})")


def grouped_phase(estimators, models, counters, smi, dev, profile=False):
    """Grouped and depthwise convolutions at full width, seeded weights in
    JAX's layout (residual branches damped by ``seeded_variables``): (a)
    ResNeXt-50 32x4d and EfficientNet-B0 through the KFAC Laplace loop of
    JAX's suite (the update rate, the invert at (1, 18916), a
    SAMPLES-sample ensemble, the NN/BNN eval and its rate), then their
    bf16 ``token_subsample=0.25`` updates; (b) the ladder on EfficientNet-B0
    (Block on a depthwise layer); (c) the dense check of the five
    estimators on ResNeXt's grouped ``GROUPED_DENSE_LAYER``; (d) one
    ConvNeXt-T update and its eval (channel LayerNorm, layer_scale, the
    depthwise 7x7 and the string-padded convs); (e) the CLI chain on
    MobileNetV2. No update, eval or CLI may launch a Gram kernel: JAX
    routes grouped layers to the batched per-group einsum before any
    kernel, its stems have C=3, and ConvNeXt's downsampling convs carry
    string padding. Returns the update paths' launches."""
    import os
    import numpy as np
    import torch
    from curvature_tpu_torch.eval import eval_nn
    from curvature_tpu_torch.pipelines import evaluate, factors
    from curvature_tpu_torch.utils.checkpoint import results_paths
    from curvature_tpu_torch.utils.config import parse_args
    none = counters.zero()
    rng = np.random.default_rng(21)
    gen = torch.Generator(device=dev).manual_seed(22)
    batches = [x for x, _ in nchw_batches(rng, UPDATES, BATCH, dev)]
    test_data = nchw_batches(rng, 2, BATCH, dev)
    by_path = {}

    def build(arch):
        model = models.build(arch, CLASSES, device=dev)
        models.load_jax_variables(model, models.seeded_variables(model, 0))
        return model.to(memory_format=torch.channels_last)

    def nn_stats(model, label):
        counters.reset()
        probs, labels = eval_nn(model, test_data)
        if counters.read() != none:
            raise AssertionError(f"{label} eval_nn launched {counters.read()}")
        log(f"{label} nn metrics (random weights, {2 * BATCH} synthetic "
            f"images): {json.dumps(prob_stats(probs, labels, label))}")

    # (a) the suite's grouped_pipeline, f32 then bf16 + token_subsample
    for arch in GROUPED_MODELS:
        model = build(arch)
        path = f"{arch}_kfac_update_img_s"
        est = estimators.KFAC(model)
        by_path[path] = drive_updates(est, batches, gen, counters, path, none)
        rate = best_rate(est, batches, gen, BATCH)
        log(f"{path}: {rate:.2f} update img/s (f32 B={BATCH} MC=1 "
            f"{SIZE}x{SIZE}, best of 3 blocks of {UPDATES} updates; {smi})")
        if profile and arch == GROUPED_MODELS[0]:
            log(f"{path} (one update):")
            profile_update(est, batches[0], gen)
        est.invert(2.0, 20000.0)              # warm, as the suite
        ensemble, invert_s = laplace_tail(est, model, test_data, gen,
                                          counters, f"{arch} kfac")
        log(f"{arch}_kfac_invert: {invert_s:.4f} s (add={ADD}, "
            f"multiply={MULTIPLY}, after a warm invert; {smi})")
        nn_stats(model, arch)
        counters.reset()
        fwd = SAMPLES * eval_rate(model, est, test_data, ensemble)
        if counters.read() != none:
            raise AssertionError(f"{arch} eval launched {counters.read()}")
        log(f"{arch}_bnn30_eval_fwd_img_s: {fwd:.2f} ({SAMPLES} x images "
            f"per second through eval_bnn, best of 3 blocks of {2 * BATCH} "
            f"images; {smi})")
        if arch == "efficientnet_b0":
            # (b) the ladder: depthwise 3x3 and 5x5 layers with SE
            lad = ladder(estimators, model, est, batches, test_data, gen,
                         counters, GROUPED_BLOCK_LAYER, f"{arch} ladder")
            for kind, (e, ens) in lad.items():
                if kind != "inf":
                    log(f"{arch} ladder {kind}: "
                        f"{best_rate(e, batches, gen, BATCH):.2f} update "
                        f"img/s ({smi})")
            del lad
        del est, ensemble
        path = f"{arch}_kfac_update{GROUPED_TAG}_img_s"
        sub = estimators.KFAC(model, compute_dtype=torch.bfloat16,
                              token_subsample=0.25)
        by_path[path] = drive_updates(sub, batches, gen, counters, path, none)
        log(f"{path}: {best_rate(sub, batches, gen, BATCH):.2f} update img/s"
            f" (bf16, token_subsample=0.25, B={BATCH} MC=1, best of 3 "
            f"blocks of {UPDATES} updates; {smi})")
        del sub
        if arch == "resnext50_32x4d":
            # (c) the five estimators on one grouped layer, densely
            dense_check(estimators, model, batches[:2], gen,
                        GROUPED_DENSE_LAYER)
        del model
        torch.cuda.empty_cache()

    # (d) ConvNeXt-T: one update and the eval
    model = build("convnext_tiny")
    est = estimators.KFAC(model)
    by_path["convnext_tiny_kfac_update"] = drive_updates(
        est, batches[:1], gen, counters, "convnext_tiny kfac (one update)",
        none)
    laplace_tail(est, model, test_data, gen, counters, "convnext_tiny kfac")
    nn_stats(model, "convnext_tiny")
    del est, model
    torch.cuda.empty_cache()

    # (e) the CLI chain on MobileNetV2: factors kfac -> diag -> efb -> inf,
    # evaluate --ood for kfac and inf
    root = os.path.abspath(os.path.join(PIPE_ROOT, "mobilenet_v2"))
    base = GROUPED_ARGV + ["--root_dir", root, "--results_dir", root]
    for name in ("kfac", "diag", "efb", "inf"):
        extra = ["--rank", GROUPED_INF_RANK] if name == "inf" else []
        est, got = run_cli(factors, base + ["--estimator", name] + extra,
                           counters, smi, f"mobilenet_v2 factors {name}")
        if got != none:
            raise AssertionError(f"mobilenet_v2 factors {name}: {got}")
        check_finite(est.state, f"mobilenet_v2 {name} state")
    for name in ("kfac", "inf"):
        argv = base + ["--estimator", name, "--ood", "--rank",
                       GROUPED_INF_RANK] + R18_DAMPING
        (probs, bnn_probs, labels), got = run_cli(
            evaluate, argv, counters, smi, f"mobilenet_v2 evaluate {name} "
            "--ood")
        with np.load(results_paths(parse_args(argv))[0] + ".npz",
                     allow_pickle=True) as f:
            auroc = f["auroc"]
        for what, p in (("nn", probs), ("bnn", bnn_probs)):
            if p.shape != (256, 10) or not np.isfinite(p).all() \
                    or np.abs(p.sum(1) - 1).max() > 1e-3:
                raise AssertionError(f"mobilenet_v2 {name} {what} "
                                     "predictions malformed")
        log(f"mobilenet_v2 synthetic {name} --ood (random weights): NN "
            f"accuracy {100 * np.mean(probs.argmax(1) == labels):.2f}%, BNN "
            f"{100 * np.mean(bnn_probs.argmax(1) == labels):.2f}%; AUROC NN "
            f"{auroc[0]:.4f} BNN {auroc[1]:.4f}")
        if got != none or not np.isfinite(auroc).all():
            raise AssertionError(f"mobilenet_v2 evaluate {name}: launches "
                                 f"{got}, AUROC {auroc}")
    return by_path


def kernel_route_check(est, plain_kw, x, expect, what):
    """The (tiled, v2) counts of ``est``'s A routes on ``x`` (one
    capture's input shapes) must be ``expect``; then every kernel-routed
    layer's A factor from that capture against a ``use_kernels=False``
    KFAC's (``plain_kw`` its other arguments), under GRAM_RTOL: the
    kernels held against their plain versions at the shapes the path gives
    them. Returns the worst error, rel to max."""
    import torch
    cap = est.capture(x, labels=torch.zeros(x.shape[0], dtype=torch.long,
                                            device=x.device))
    routes = {n: est.a_route(m, cap.acts[n].shape,
                             cap.acts[n].element_size())
              for n, m in est.metas.items()}
    counts = tuple(list(routes.values()).count(r) for r in ("tiled", "v2"))
    if counts != tuple(expect):
        raise AssertionError(f"{what}: (tiled, v2) routes {counts}, want "
                             f"{tuple(expect)}")
    names = [n for n, r in routes.items() if r in ("tiled", "v2")]
    worst = 0.0
    if names:
        plain = est.__class__(est.model, use_kernels=False,
                              layer_filter=names, **plain_kw)
        for name in names:
            act = cap.acts[name]
            got = est._a_factor(est.metas[name], act)
            want = plain._a_factor(plain.metas[name], act)
            rel = float((got - want).abs().max() / want.abs().max())
            worst = max(worst, rel)
            if not (torch.isfinite(got).all() and rel <= GRAM_RTOL):
                raise AssertionError(
                    f"{what} {name} ({routes[name]}, input "
                    f"{tuple(act.shape)}): A factor rel err {rel:.3e}")
        shapes = sorted({(routes[n], tuple(cap.acts[n].shape),
                          est.metas[n].kernel_size) for n in names})
        log(f"{what}: {len(names)} kernel-routed A factors vs "
            f"use_kernels=False, worst rel {worst:.3e} (bar {GRAM_RTOL}); "
            f"(route, input, kernel): {shapes}")
    return worst


def zoo_phase(estimators, models, counters, smi, dev, profile=False):
    """The reference's classic torchvision CNNs at full width, seeded
    weights in JAX's layout: (a) DenseNet-121 at 224², B=16 through the
    KFAC loop of the ResNet-50 row (the update rate, its denseblock4 3x3
    convs through the tiled kernel, invert, a SAMPLES-sample ensemble, the
    bnn30 eval rate, the bf16 ``token_subsample=0.25`` rate); (b) one
    update, invert and a ZOO_SAMPLES-sample eval of each of ZOO_FAMILIES
    at B=8, VGG-16 with ``max_factor_dim`` past its 25,089-wide
    ``classifier.0`` A factor; (c) the CLI chain ``factors -> evaluate
    --ood`` of DenseNet-121 on a CIFAR-10 pickle tree and an SVHN .mat
    written here, from a torchvision-layout ``.pth``; (d) the regression
    cell, ``mlp`` with ``loss='gaussian'`` on a UCI CSV. Every update's
    launches are asserted from ZOO_ROUTES (JAX's routes), and every
    kernel-routed layer's A factor is held against the plain path.
    Returns the launches by path."""
    import os
    import numpy as np
    import torch
    from curvature_tpu_torch.data import loaders
    from curvature_tpu_torch.eval import eval_bnn
    from curvature_tpu_torch.eval.metrics import gaussian_nll
    from curvature_tpu_torch.eval.predictive import eval_bnn_regression
    none = counters.zero()
    rng = np.random.default_rng(31)
    gen = torch.Generator(device=dev).manual_seed(32)
    by_path = {}

    def build(arch, classes=CLASSES):
        model = models.build(arch, classes, device=dev)
        models.load_jax_variables(model, models.seeded_variables(model, 0))
        return model.to(memory_format=torch.channels_last)

    def launches(tiled, v2, n=1):
        return dict(none, patch_gram_tiled=tiled * n, patch_gram_v2=v2 * n)

    # (a) DenseNet-121: the KFAC loop, f32 then bf16 + token_subsample
    t0 = time.perf_counter()
    model = build("densenet121")
    batches = [x for x, _ in nchw_batches(rng, UPDATES, BATCH, dev)]
    test_data = nchw_batches(rng, 2, BATCH, dev)
    routes = ZOO_ROUTES["densenet121", BATCH, SIZE]
    est = estimators.KFAC(model)
    by_path[ZOO_PATHS[0]] = drive_updates(est, batches, gen, counters,
                                          ZOO_PATHS[0],
                                          launches(*routes, UPDATES))
    kernel_route_check(est, {}, batches[-1], routes,
                       f"densenet121 f32 B={BATCH}")
    rate = best_rate(est, batches, gen, BATCH)
    log(f"{ZOO_PATHS[0]}: {rate:.2f} update img/s (f32 B={BATCH} MC=1 "
        f"{SIZE}x{SIZE}, best of 3 blocks of {UPDATES} updates; {smi})")
    if profile:
        log(f"{ZOO_PATHS[0]} (one update):")
        profile_update(est, batches[0], gen)
    damping = ZOO_DAMPING["densenet121"]
    ensemble, invert_s = laplace_tail(est, model, test_data, gen, counters,
                                      "densenet121 kfac", damping)
    log(f"densenet121_kfac_invert: {invert_s:.4f} s (add={damping[0]}, "
        f"multiply={damping[1]}; {smi})")
    counters.reset()
    bnn_img_s = eval_rate(model, est, test_data, ensemble)
    if counters.read() != none:
        raise AssertionError(f"densenet121 eval launched {counters.read()}")
    log(f"densenet121_bnn30_eval_img_s: {bnn_img_s:.2f} (best of 3 blocks "
        f"of {2 * BATCH} images x {SAMPLES} samples; {smi})")
    del est, ensemble
    sub = estimators.KFAC(model, compute_dtype=torch.bfloat16,
                          token_subsample=0.25)
    by_path[ZOO_PATHS[1]] = drive_updates(sub, batches, gen, counters,
                                          ZOO_PATHS[1], none)
    log(f"{ZOO_PATHS[1]}: {best_rate(sub, batches, gen, BATCH):.2f} update "
        f"img/s (bf16, token_subsample=0.25, B={BATCH} MC=1, best of 3 "
        f"blocks of {UPDATES} updates; {smi})")
    del sub, model, batches, test_data
    torch.cuda.empty_cache()
    log(f"zoo densenet121: {time.perf_counter() - t0:.1f} s")

    # (b) the other families: one update, invert, a short eval
    for arch in ZOO_FAMILIES:
        t0 = time.perf_counter()
        size = 299 if arch == "inception_v3" else SIZE
        model = build(arch)
        xs, ys = synthetic(rng, ZOO_BATCH, size)
        x = torch.from_numpy(np.ascontiguousarray(xs.transpose(
            0, 3, 1, 2))).to(dev).contiguous(
                memory_format=torch.channels_last)
        kw = {"max_factor_dim": ZOO_MAX_FACTOR_DIM}
        est = estimators.KFAC(model, **kw)
        routes = ZOO_ROUTES[arch, ZOO_BATCH, size]
        path = f"{arch}_kfac_update"
        by_path[path] = drive_updates(est, [x], gen, counters, path,
                                      launches(*routes))
        kernel_route_check(est, kw, x, routes, f"{arch} f32 B={ZOO_BATCH}")
        damping = ZOO_DAMPING.get(arch, ZOO_DEFAULT_DAMPING)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        est.invert(*damping)
        torch.cuda.synchronize()
        invert_s = time.perf_counter() - t1
        check_finite(est.inv_state, f"{arch} inv_state")
        ensemble = est.ensemble_params(ZOO_SAMPLES, generator=gen)
        counters.reset()
        probs, labels, _ = eval_bnn(model, est, [(x, ys)],
                                    samples=ZOO_SAMPLES,
                                    ensemble_params=ensemble)
        if counters.read() != none:
            raise AssertionError(f"{arch} eval launched {counters.read()}")
        if probs.shape != (ZOO_BATCH, CLASSES) \
                or not np.isfinite(probs).all() \
                or np.abs(probs.sum(1) - 1).max() > 1e-3:
            raise AssertionError(f"{arch} bnn probabilities malformed")
        extra = ""
        if arch == "vgg16":
            a = est.state["classifier.0"]["a"]
            extra = (f"; classifier.0 A {tuple(a.shape)} "
                     f"({a.numel() * 4 / 2**30:.2f} GiB); memory in use "
                     f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
                     f"peak so far {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                     " GiB")
        log(f"{arch} ({size}x{size}, B={ZOO_BATCH}): update launches "
            f"{json.dumps(by_path[path])}; invert(add={damping[0]}, "
            f"multiply={damping[1]}) {invert_s:.3f} s; {ZOO_SAMPLES}-sample "
            "bnn: "
            f"finite{extra}; phase {time.perf_counter() - t0:.1f} s ({smi})")
        del est, ensemble, model, x
        torch.cuda.empty_cache()

    # (c) the CLI chain on array-format files, from a .pth
    by_path[ZOO_CLI_PATH] = zoo_cli(models, counters, smi, rng)

    # (d) regression: mlp, loss='gaussian', on a UCI CSV
    t0 = time.perf_counter()
    data = os.path.abspath(os.path.join(ZOO_ROOT, "data"))
    os.makedirs(os.path.join(data, "uci"), exist_ok=True)
    xr = rng.standard_normal((ZOO_UCI_ROWS, ZOO_UCI_FEATURES))
    yr = np.sin(xr[:, 0]) + 0.5 * xr[:, 1] * xr[:, 2] \
        + 0.1 * rng.standard_normal(ZOO_UCI_ROWS)
    np.savetxt(os.path.join(data, "uci", "concrete.csv"),
               np.column_stack([xr, yr]), delimiter=",", fmt="%.6f",
               header=",".join([f"x{i}" for i in range(ZOO_UCI_FEATURES)]
                               + ["y"]), comments="")
    (xtr, ytr), (xte, yte) = loaders.uci(data, "concrete")
    model = models.build("mlp", 1, device=dev, in_features=ZOO_UCI_FEATURES)
    models.load_jax_variables(model, models.seeded_variables(model, 0))
    est = estimators.KFAC(model, loss="gaussian")
    counters.reset()
    for i in range(0, len(xtr), 64):
        x = torch.from_numpy(xtr[i:i + 64]).to(dev)
        est.update(x, labels=torch.from_numpy(ytr[i:i + 64, None]).to(dev))
        est.update(x, generator=gen, num_samples=4)
    if counters.read() != none:
        raise AssertionError(f"regression launched {counters.read()}")
    check_finite(est.state, "mlp gaussian state")
    est.invert(1.0, float(len(xtr)))
    check_finite(est.inv_state, "mlp gaussian inv_state")
    ensemble = est.ensemble_params(SAMPLES, generator=gen)
    mean, var, targets = eval_bnn_regression(
        model, est, [(torch.from_numpy(xte).to(dev), yte[:, None])],
        SAMPLES, ensemble_params=ensemble)
    if mean.shape != (len(xte), 1) or not np.isfinite(mean).all() \
            or not (np.isfinite(var).all() and (var >= 1.0).all()):
        raise AssertionError("mlp gaussian predictive malformed")
    log(f"mlp uci regression (random weights, loss='gaussian', "
        f"{len(xtr)} train / {len(xte)} test rows): {SAMPLES}-sample "
        f"linearized predictive RMSE "
        f"{float(np.sqrt(np.mean((mean - targets) ** 2))):.4f}, Gaussian "
        f"NLL {float(gaussian_nll(mean, var, targets)):.4f}; "
        f"{time.perf_counter() - t0:.1f} s")
    return by_path


def zoo_cli(models, counters, smi, rng):
    """Write a CIFAR-10 pickle tree, an SVHN test .mat and a
    torchvision-layout ``densenet121_cifar10.pth`` under ZOO_ROOT, then
    ``factors --estimator kfac`` (its launches asserted from ZOO_ROUTES,
    the kernel-routed A factors of one of its batches against the plain
    path) and ``evaluate --ood`` (no launch). Returns the factors run's
    launches."""
    import os
    import pickle
    import numpy as np
    import scipy.io
    import torch
    from curvature_tpu_torch.pipelines import common, evaluate, factors
    from curvature_tpu_torch.utils.checkpoint import results_paths
    from curvature_tpu_torch.utils.config import parse_args
    none = counters.zero()
    t0 = time.perf_counter()
    root = os.path.abspath(ZOO_ROOT)
    data = os.path.join(root, "data")
    cifar = os.path.join(data, "cifar-10-batches-py")
    for d in (cifar, os.path.join(data, "svhn"), os.path.join(root,
                                                              "weights")):
        os.makedirs(d, exist_ok=True)
    for i in range(1, 6):
        with open(os.path.join(cifar, f"data_batch_{i}"), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (ZOO_CIFAR_TRAIN,
                                                        3072), np.uint8),
                         b"labels": rng.integers(0, 10, ZOO_CIFAR_TRAIN)
                         .tolist()}, f)
    with open(os.path.join(cifar, "test_batch"), "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (ZOO_TEST, 3072),
                                           np.uint8),
                     b"labels": rng.integers(0, 10, ZOO_TEST).tolist()}, f)
    scipy.io.savemat(os.path.join(data, "svhn", "test_32x32.mat"), {
        "X": rng.integers(0, 256, (32, 32, 3, ZOO_TEST), np.uint8),
        "y": rng.integers(1, 11, (ZOO_TEST, 1))})
    seeded = models.build("densenet121", 10, device="cpu")
    models.load_jax_variables(seeded, models.seeded_variables(seeded, 0))
    torch.save(models.export_torch_state_dict(seeded.state_dict()),
               os.path.join(root, "weights", "densenet121_cifar10.pth"))
    log(f"zoo files (CIFAR-10 pickles, SVHN .mat, .pth): "
        f"{time.perf_counter() - t0:.1f} s")
    base = ZOO_ARGV + ["--data_dir", data, "--root_dir", root,
                       "--results_dir", root]
    est, got = run_cli(factors, base + ["--estimator", "kfac"], counters,
                       smi, "densenet121 cifar10 factors kfac")
    routes = ZOO_ROUTES["densenet121", 32, 32]
    want = dict(none, patch_gram_tiled=routes[0] * ZOO_CLI_UPDATES,
                patch_gram_v2=routes[1] * ZOO_CLI_UPDATES)
    if got != want or est.num_updates != ZOO_CLI_UPDATES:
        raise AssertionError(f"{ZOO_CLI_PATH}: launches {got}, want {want};"
                             f" {est.num_updates} updates")
    check_finite(est.state, f"{ZOO_CLI_PATH} state")
    for name, p in est.model.state_dict().items():
        if not torch.equal(p.cpu(), seeded.state_dict()[name]):
            raise AssertionError(f"the .pth did not load: {name}")
    x = next(common.on_device(common.build_data(parse_args(base), "train"),
                              est.device))[0]
    kernel_route_check(est, {}, x, routes, "densenet121 cifar10 B=32")
    argv = base + ["--estimator", "kfac", "--ood"] + R18_DAMPING
    (probs, bnn_probs, labels), got = run_cli(
        evaluate, argv, counters, smi, "densenet121 cifar10 evaluate --ood")
    with np.load(results_paths(parse_args(argv))[0] + ".npz",
                 allow_pickle=True) as f:
        auroc = f["auroc"]
    n = ZOO_TEST // 2
    for what, p in (("nn", probs), ("bnn", bnn_probs)):
        if p.shape != (n, 10) or not np.isfinite(p).all() \
                or np.abs(p.sum(1) - 1).max() > 1e-3:
            raise AssertionError(f"densenet121 cifar10 {what} predictions "
                                 "malformed")
    if got != none or not np.isfinite(auroc).all():
        raise AssertionError(f"densenet121 evaluate: launches {got}, AUROC "
                             f"{auroc}")
    log(f"densenet121 cifar10 --ood svhn (random weights): NN accuracy "
        f"{100 * np.mean(probs.argmax(1) == labels):.2f}%, BNN "
        f"{100 * np.mean(bnn_probs.argmax(1) == labels):.2f}%; AUROC NN "
        f"{auroc[0]:.4f} BNN {auroc[1]:.4f}")
    return want


def transformer_phase(estimators, models, counters, smi, dev, profile=False):
    """The JAX zoo's vision transformers at full width (224², 1000 classes,
    seeded weights in JAX's layout, f32 unless said, TF32 off): (a)
    ViT-B/16 through JAX's ``vit_pipeline`` (benchmarks/suite.py:267-313):
    KFAC with ``attention_qkv_split`` at B=16, MC=1, one warm update then
    the best of 3 blocks of UPDATES (``vit_b16_kfac_update_img_s``), a warm
    invert then ``invert(1, 18916)`` timed (``vit_b16_kfac_invert_50layers``),
    a SAMPLES-sample ensemble and its eval (``vit_b16_bnn30_eval_fwd_img_s``);
    then ``attention_head_split`` (one update, invert, sample, the split
    shapes), bf16 (one update) and ``scan_blocks=True`` (one update, each
    depth slice against the unrolled model's factors); (b) Swin-T through
    the same loop (``swin_t_kfac_update_img_s``,
    ``swin_t_bnn30_eval_fwd_img_s``) and one update, invert and sample of
    Swin-V2-T; (c) MaxViT-T's f32 update (``maxvit_t_kfac_update_img_s``),
    each launching the tiled patch-Gram kernel once (``stem.1.0``), its A
    factor held against the plain path, bf16 launching none, the
    BatchNorms' running statistics unchanged by the captures; (d) the
    ``factors -> evaluate --ood`` CLIs of ViT-B/16 with ``--qkv_split`` and
    a Swin-T ``factors`` run under TRANSFORMER_ROOT. Returns the update
    paths' launches."""
    import os
    import numpy as np
    import torch
    from curvature_tpu_torch.pipelines import evaluate, factors
    from curvature_tpu_torch.utils.checkpoint import results_paths
    from curvature_tpu_torch.utils.config import parse_args
    none = counters.zero()
    rng = np.random.default_rng(41)
    gen = torch.Generator(device=dev).manual_seed(42)
    batches = [x for x, _ in nchw_batches(rng, UPDATES, BATCH, dev)]
    test_data = nchw_batches(rng, 2, BATCH, dev)
    labels = torch.arange(BATCH, device=dev)
    by_path = {}

    def build(arch, **kw):
        model = models.build(arch, CLASSES, device=dev, **kw)
        variables = models.seeded_variables(model, 0)
        models.load_jax_variables(model, variables)
        return model.to(memory_format=torch.channels_last), variables

    def loop(arch, est, model, path):
        """The suite's loop: warm update, rate, invert, eval rate."""
        est.update(batches[0], generator=gen)          # warm
        by_path[path] = drive_updates(est, batches, gen, counters, path,
                                      expect[path])
        rate = best_rate(est, batches, gen, BATCH)
        log(f"{path}: {rate:.2f} update img/s (f32 B={BATCH} MC=1 "
            f"{SIZE}x{SIZE}, best of 3 blocks of {UPDATES} updates; {smi})")
        if profile and path == TRANSFORMER_PATHS[0]:
            log(f"{path} (one update):")
            profile_update(est, batches[0], gen)
        est.invert(2.0, 20000.0)                        # warm, as the suite
        ensemble, invert_s = laplace_tail(est, model, test_data, gen,
                                          counters, f"{arch} kfac")
        counters.reset()
        fwd = SAMPLES * eval_rate(model, est, test_data, ensemble)
        if counters.read() != none:
            raise AssertionError(f"{arch} eval launched {counters.read()}")
        return invert_s, fwd

    def split_shapes(est, name, want):
        got = {k: tuple(v.shape) for k, v in est.state[name].items()}
        if got != want:
            raise AssertionError(f"{name}: split factor shapes {got}, want "
                                 f"{want}")

    expect = {TRANSFORMER_PATHS[0]: none, TRANSFORMER_PATHS[1]: none,
              TRANSFORMER_PATHS[2]: dict(
                  none, patch_gram_tiled=MAXVIT_ROUTES[0] * UPDATES,
                  patch_gram_v2=MAXVIT_ROUTES[1] * UPDATES)}

    # (a) ViT-B/16: the suite's loop with the qkv split
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model, variables = build("vit_b_16")
    est = estimators.KFAC(model, attention_qkv_split=True)
    if len(est.metas) != 50:
        raise AssertionError(f"vit_b_16: {len(est.metas)} tracked layers")
    invert_s, fwd = loop("vit_b_16", est, model, TRANSFORMER_PATHS[0])
    log(f"vit_b16_kfac_invert_50layers: {invert_s:.4f} s (add={ADD}, "
        f"multiply={MULTIPLY}, after a warm invert; {smi})")
    log(f"vit_b16_bnn30_eval_fwd_img_s: {fwd:.2f} ({SAMPLES} x images per "
        f"second through eval_bnn, best of 3 blocks of {2 * BATCH} images; "
        f"{smi})")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"vit_b_16 peak memory: {peak:.2f} GiB ({smi})")
    inp = "encoder.layers.encoder_layer_0.self_attention/in_proj"
    out = "encoder.layers.encoder_layer_0.self_attention/out_proj"
    split_shapes(est, inp, {"a": (769, 769), "g": (3, 768, 768)})
    del est
    torch.cuda.empty_cache()
    head = estimators.KFAC(model, attention_head_split=True)
    drive_updates(head, batches[:1], gen, counters, "vit_b_16 head split",
                  none)
    split_shapes(head, inp, {"a": (769, 769), "g": (3, 12, 64, 64)})
    split_shapes(head, out, {"a": (12, 64, 64), "g": (768, 768),
                             "a_bias": ()})
    head.invert(ADD, MULTIPLY)
    check_finite(head.inv_state, "vit_b_16 head split inv_state")
    draw = head.sample(generator=gen)
    check_finite(draw, "vit_b_16 head split sample")
    log(f"vit_b_16 attention_head_split: update, invert, sample finite; "
        f"{inp} G {tuple(head.state[inp]['g'].shape)}, {out} A "
        f"{tuple(head.state[out]['a'].shape)} + a_bias "
        f"{float(head.state[out]['a_bias']):.1f} ({smi})")
    del head, draw
    b16 = estimators.KFAC(model, compute_dtype=torch.bfloat16,
                          attention_qkv_split=True)
    drive_updates(b16, batches[:1], gen, counters, "vit_b_16 bf16", none)
    log(f"vit_b_16 bf16 (compute_dtype=bfloat16, qkv split): one update, "
        f"factors finite ({smi})")
    del b16
    flat = estimators.KFAC(model)
    flat.update(batches[0], labels=labels)
    scan = models.build("vit_b_16", CLASSES, device=dev, scan_blocks=True)
    models.load_jax_variables(scan, models.stack_scan_groups(variables,
                                                             scan))
    scan = scan.to(memory_format=torch.channels_last)
    stacked = estimators.KFAC(scan)
    counters.reset()
    stacked.update(batches[0], labels=labels)
    if counters.read() != none:
        raise AssertionError(f"vit_b_16 scan launched {counters.read()}")
    worst = 0.0
    for name, meta in stacked.metas.items():
        for i in range(meta.stacked or 1):
            per = (name if not meta.stacked else
                   name.replace("encoder.layers.",
                                f"encoder.layers.encoder_layer_{i}.", 1))
            for key in ("a", "g"):
                got = stacked.state[name][key]
                got = got[i] if meta.stacked else got
                want = flat.state[per][key]
                rel = float((got - want).abs().max() / want.abs().max())
                worst = max(worst, rel)
    log(f"vit_b_16 scan_blocks=True: stacked factors vs the unrolled "
        f"model's, worst rel {worst:.3e} of max (bar {SCAN_RTOL}; {smi})")
    if not worst <= SCAN_RTOL:
        raise AssertionError(f"vit_b_16 scan vs unrolled: {worst:.3e}")
    del flat, stacked, scan, model, variables
    torch.cuda.empty_cache()
    log(f"transformers vit_b_16: {time.perf_counter() - t0:.1f} s ({smi})")

    # (b) Swin-T through the loop; Swin-V2-T's update, invert, sample
    t0 = time.perf_counter()
    model, _ = build("swin_t")
    est = estimators.KFAC(model)
    _, fwd = loop("swin_t", est, model, TRANSFORMER_PATHS[1])
    log(f"swin_t_bnn30_eval_fwd_img_s: {fwd:.2f} ({SAMPLES} x images per "
        f"second through eval_bnn, best of 3 blocks of {2 * BATCH} images; "
        f"{smi})")
    del est, model
    torch.cuda.empty_cache()
    model, _ = build("swin_v2_t")
    est = estimators.KFAC(model)
    x = nchw_batches(rng, 1, BATCH, dev, SWIN_V2_SIZE)[0][0]
    drive_updates(est, [x], gen, counters, "swin_v2_t", none)
    est.invert(ADD, MULTIPLY)
    check_finite(est.inv_state, "swin_v2_t inv_state")
    check_finite(est.sample(generator=gen), "swin_v2_t sample")
    log(f"swin_v2_t ({SWIN_V2_SIZE}x{SWIN_V2_SIZE}, B={BATCH}): one update, "
        f"invert(add={ADD}, multiply={MULTIPLY}), sample finite ({smi})")
    del est, model
    torch.cuda.empty_cache()
    log(f"transformers swin: {time.perf_counter() - t0:.1f} s ({smi})")

    # (c) MaxViT-T: the tiled kernel on stem.1.0 in f32, none in bf16
    t0 = time.perf_counter()
    model, _ = build("maxvit_t")
    running = {k: v.clone() for k, v in model.state_dict().items()
               if "running" in k}
    est = estimators.KFAC(model)
    path = TRANSFORMER_PATHS[2]
    by_path[path] = drive_updates(est, batches, gen, counters, path,
                                  expect[path])
    rel = kernel_route_check(est, {}, batches[-1], MAXVIT_ROUTES,
                             f"maxvit_t f32 B={BATCH}")
    rate = best_rate(est, batches, gen, BATCH)
    log(f"{path}: {rate:.2f} update img/s (f32 B={BATCH} MC=1 {SIZE}x{SIZE},"
        f" best of 3 blocks of {UPDATES} updates; {SIZE // 32}-partition "
        f"windows; {smi})")
    del est
    b16 = estimators.KFAC(model, compute_dtype=torch.bfloat16)
    got = drive_updates(b16, batches[:1], gen, counters, "maxvit_t bf16",
                        none)
    del b16
    for k, v in running.items():
        if not torch.equal(model.state_dict()[k], v):
            raise AssertionError(f"maxvit_t: the capture moved {k}")
    log(f"maxvit_t: tiled launches {by_path[path]['patch_gram_tiled']} in "
        f"{UPDATES} f32 updates, {got['patch_gram_tiled']} in a bf16 update;"
        f" stem.1.0's A factor {rel:.3e} of max from the plain path (bar "
        f"{GRAM_RTOL}); {len(running)} running statistics unchanged by the "
        f"captures ({smi})")
    del model
    torch.cuda.empty_cache()
    log(f"transformers maxvit_t: {time.perf_counter() - t0:.1f} s ({smi})")

    # (d) the CLIs
    root = os.path.abspath(TRANSFORMER_ROOT)
    base = ["--root_dir", root, "--results_dir", root]
    vit = VIT_ARGV + base
    est, got = run_cli(factors, vit + ["--estimator", "kfac"], counters, smi,
                       "vit_b_16 synthetic factors kfac --qkv_split")
    name = "encoder.layers.encoder_layer_11.self_attention/in_proj"
    if got != none or tuple(est.state[name]["g"].shape) != (3, 768, 768) \
            or len(est.metas) != 5:
        raise AssertionError(f"vit_b_16 factors: launches {got}, "
                             f"{sorted(est.metas)}")
    check_finite(est.state, "vit_b_16 factors state")
    argv = vit + ["--estimator", "kfac", "--ood"] + R18_DAMPING
    (probs, bnn_probs, labels), got = run_cli(
        evaluate, argv, counters, smi, "vit_b_16 synthetic evaluate --ood")
    with np.load(results_paths(parse_args(argv))[0] + ".npz",
                 allow_pickle=True) as f:
        auroc = f["auroc"]
    for what, p in (("nn", probs), ("bnn", bnn_probs)):
        if p.shape != (256, 10) or not np.isfinite(p).all() \
                or np.abs(p.sum(1) - 1).max() > 1e-3:
            raise AssertionError(f"vit_b_16 {what} predictions malformed")
    if got != none or not np.isfinite(auroc).all():
        raise AssertionError(f"vit_b_16 evaluate: launches {got}, AUROC "
                             f"{auroc}")
    log(f"vit_b_16 synthetic --ood (random weights): NN accuracy "
        f"{100 * np.mean(probs.argmax(1) == labels):.2f}%, BNN "
        f"{100 * np.mean(bnn_probs.argmax(1) == labels):.2f}%; AUROC NN "
        f"{auroc[0]:.4f} BNN {auroc[1]:.4f}")
    est, got = run_cli(factors, SWIN_ARGV + base + ["--estimator", "kfac"],
                       counters, smi, "swin_t synthetic factors kfac")
    if got != none:
        raise AssertionError(f"swin_t factors launched {got}")
    check_finite(est.state, "swin_t factors state")
    return by_path


def train_step_ms(step, batches, reps=3):
    """Wall ms per training step: ``step(x, y)`` over ``batches`` after one
    warm pass, best of ``reps`` passes, each ended by a synchronize."""
    import torch
    for x, y in batches:
        step(x, y)
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x, y in batches:
            step(x, y)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return 1e3 * best / len(batches)


def training_phase(estimators, counters, smi, dev, profile=False):
    """Training, the KFAC optimizer, SWAG and the loss landscape (JAX
    pipelines/training.py, optim.py, estimators/swag.py,
    pipelines/loss_landscape.py), each CLI ``main(argv)`` in-process under
    ``TRAIN_ROOT``: (a) LeNet-5 on the digits trained by SGD from the
    seeded initialization, then ``factors`` (kfac, diag) -> ``hyper`` ->
    ``evaluate`` on the checkpoint it wrote, the loss landscape twice
    (the second call computes nothing), ``--swag`` and the SWAG
    posterior's eval, no Gram kernel anywhere; (b) ResNet-18 at full
    width with SGD, Adam and the KFAC optimizer, whose steps launch the
    patch-Gram kernels by JAX's routes (``R18_ROUTES``), its A factors
    held against the plain path; SWAG with ``--bn_update``; a loss line
    at full width. Prints the rates, the re-invert and the seconds per
    landscape point. Returns {TRAIN_PATH: launches}."""
    import os
    import shutil
    import numpy as np
    import torch
    from curvature_tpu_torch import models, optim
    from curvature_tpu_torch.data.loaders import FIXTURE_DIR
    from curvature_tpu_torch.estimators.base import normalize_damping
    from curvature_tpu_torch.pipelines import (
        common, evaluate, factors, hyper, loss_landscape, training)
    from curvature_tpu_torch.utils.checkpoint import (
        results_paths, save_pytree)
    from curvature_tpu_torch.utils.config import parse_args
    t_phase = time.perf_counter()
    none = counters.zero()
    shutil.rmtree(TRAIN_ROOT, ignore_errors=True)

    def cli(module, argv, label, want=None):
        out, got = run_cli(module, argv, counters, smi, label)
        if got != (want or none):
            raise AssertionError(f"{label}: launches {got}, want "
                                 f"{want or none}")
        return out

    def batches_of(cfg):
        """The training batches ``training.run`` reads (its train split)."""
        train = common.build_data(cfg, splits=("train", "val"))[0]
        return [(x, torch.as_tensor(np.asarray(y), device=dev).long())
                for x, y in common.on_device(train, dev)]

    def accuracy(probs, labels):
        return 100.0 * float(np.mean(np.asarray(probs).argmax(1)
                                     == np.asarray(labels)))

    # (a) LeNet-5 on the digits, from the seeded initialization
    root = os.path.abspath(os.path.join(TRAIN_ROOT, "lenet5"))
    base = LENET_ARGV + ["--data_dir", FIXTURE_DIR, "--root_dir", root,
                         "--results_dir", root]
    cfg = parse_args(base)
    save_pytree(training.weights_path(cfg), models.seeded_variables(
        models.lenet5(10, device="cpu"), TRAIN_LENET_SEED))
    (model, hist), seconds = timed(lambda: cli(
        training, base + TRAIN_LENET, "lenet5 training sgd "
        + " ".join(TRAIN_LENET)))
    probs, labels = cli(evaluate, base, "lenet5 evaluate (test)")
    test_acc = accuracy(probs, labels)
    log(f"lenet5 digits trained on the card ({' '.join(TRAIN_LENET)}, B=32,"
        f" 16 steps an epoch): loss {hist['loss'][0]:.4f} -> "
        f"{hist['loss'][-1]:.4f}, val {hist['val_acc'][-1]:.2f}%, test "
        f"{test_acc:.2f}% (JAX package on the CPU, same flags: "
        f"{JAX_LENET_TEST_ACC:.2f}%); {seconds:.3f} s wall ({smi})")
    if not np.isfinite(hist["loss"]).all() \
            or abs(test_acc - JAX_LENET_TEST_ACC) > 3.0:
        raise AssertionError(f"lenet5 training: test {test_acc:.2f}% vs "
                             f"JAX's {JAX_LENET_TEST_ACC:.2f}%, {hist}")
    sgd = torch.optim.SGD(model.parameters(), lr=1e-4, momentum=0.9)
    ms = train_step_ms(training.make_train_step(model, sgd),
                       batches_of(cfg))
    log(f"lenet5 sgd train step B=32: {ms:.3f} ms, {1e3 / ms:.1f} it/s, "
        f"{32e3 / ms:.1f} img/s (the reference's ~317-333 it/s, "
        f"BASELINE.md:19; {smi})")
    for name in ("kfac", "diag"):
        cli(factors, base + ["--estimator", name], f"lenet5 factors {name}"
            " (trained)")
    cli(hyper, base + ["--estimator", "kfac"] + TRAIN_HYPER,
        "lenet5 hyper kfac " + " ".join(TRAIN_HYPER))
    stats, bnn = cli(evaluate, base + ["--estimator", "kfac", "--fgsm"]
                     + FGSM_CHAIN_SAMPLES,
                     "lenet5 evaluate kfac --fgsm at the searched damping")
    log(f"lenet5 chain on the trained checkpoint: NN {stats['acc'][0]:.2f}%"
        f", BNN {bnn['acc'][0]:.2f}% (ECE {bnn['ece1'][0]:.2f}%, NLL "
        f"{bnn['nll'][0]:.4f}); FGSM eps 0.1: NN {stats['acc'][5]:.2f}%, "
        f"BNN {bnn['acc'][5]:.2f}%")
    if bnn["acc"][0] <= 50.0:
        raise AssertionError(f"lenet5 chain: BNN {bnn['acc'][0]:.2f}%")
    for flag, keys, points in (("--loss1d", ("train_loss", "val_loss"),
                                51 * 2), ("--loss2d", ("loss",), 21 * 21)):
        path = f"{results_paths(cfg)[0]}_{flag[2:]}.npy"
        res, seconds = timed(lambda: cli(loss_landscape, base + [flag],
                                         f"lenet5 loss_landscape {flag}"))
        stamp = os.stat(path).st_mtime_ns
        again = cli(loss_landscape, base + [flag],
                    f"lenet5 loss_landscape {flag} (resumed)")
        if os.stat(path).st_mtime_ns != stamp \
                or any(not np.array_equal(again[k], res[k]) for k in res) \
                or any(not np.isfinite(res[k]).all() for k in keys):
            raise AssertionError(f"lenet5 {flag}: the resumed call "
                                 "computed or changed something")
        centre = np.ravel(res[keys[0]])[np.size(res[keys[0]]) // 2]
        log(f"lenet5 {flag}: {points} points in {seconds:.3f} s, "
            f"{seconds / points:.5f} s per point; train loss at the centre "
            f"{centre:.4f}, at most {float(np.max(res[keys[0]])):.4f}; the "
            f"resumed call computed nothing ({smi})")
    hist = cli(training, base + TRAIN_SWAG, "lenet5 training "
               + " ".join(TRAIN_SWAG))[1]
    stats, bnn = cli(evaluate, base + ["--estimator", "swag", "--fgsm"]
                     + TRAIN_SWAG_DAMPING + FGSM_CHAIN_SAMPLES,
                     "lenet5 evaluate swag --fgsm")
    log(f"lenet5 swag ({TRAIN_SWAG[1]} more epochs, the last 2 collected):"
        f" NN {stats['acc'][0]:.2f}%, SWAG BNN {bnn['acc'][0]:.2f}% (ECE "
        f"{bnn['ece1'][0]:.2f}%); val {hist['val_acc'][-1]:.2f}%")
    if bnn["acc"][0] <= 50.0:
        raise AssertionError(f"lenet5 swag: BNN {bnn['acc'][0]:.2f}%")

    # (b) ResNet-18 at full width on synthetic data
    def r18(opt):
        root = os.path.abspath(os.path.join(TRAIN_ROOT, f"resnet18_{opt}"))
        return R18_ARGV + TRAIN_R18 + ["--root_dir", root, "--results_dir",
                                       root]
    cfg = parse_args(r18("sgd"))
    batches = batches_of(cfg)
    steps = cfg.epochs * len(batches)
    by_path = {}
    for opt, flags in TRAIN_R18_OPTS.items():
        argv = r18(opt) + ["--optimizer", opt] + flags
        want = none
        if opt == "kfac":
            # one factor pass a step, and one for the first batch
            want = dict(none, **{f"patch_gram_{r}": n * (steps + 1) for r, n
                                 in R18_ROUTES[R18_PATHS[0]].items()})
        (model, hist), seconds = timed(lambda: cli(
            training, argv, f"resnet18 training {opt}", want))
        log(f"resnet18 {opt}: {steps} steps of B=32 ({len(batches) * 32} "
            f"synthetic images, {cfg.epochs} epochs), loss "
            f"{hist['loss'][0]:.4f} -> {hist['loss'][-1]:.4f}; "
            f"{seconds:.3f} s wall with the set-up and the checkpoint")
        if not np.isfinite(hist["loss"]).all():
            raise AssertionError(f"resnet18 {opt}: loss {hist['loss']}")
        if opt == "kfac":
            by_path[TRAIN_PATH] = counters.read()
            est = estimators.KFAC(model)
            x = batches[0][0]
            for layer, route in R18_CHECKED.items():
                a_factor_check(est, estimators.KFAC(
                    model, use_kernels=False, layer_filter=[layer]), x,
                    layer, f"resnet18 training kfac, {route} s"
                    f"{est.metas[layer].strides[0]}", route)
            tx = torch.optim.SGD(model.parameters(), lr=1e-4, momentum=0.9)
            kstep, kinit = optim.make_kfac_train_step(model, est, tx)
            state = list(kinit(*batches[0]))
            state.append(1)

            def step(x, y):
                state[0], state[1], state[2], _ = kstep(
                    state[0], state[1], state[2], x, y)
            add, mult = normalize_damping(1e-2, 1.0, len(est.metas), dev)
            _, inv_s = timed(lambda: est.invert_state(state[0], add, mult))
            log(f"resnet18 kfac optimizer re-invert ({len(est.metas)} "
                f"layers, damping 1e-2): {inv_s:.4f} s ({smi})")
            if profile:
                log(f"resnet18 training kfac, one step (B=32; a re-invert "
                    "every 10th):")
                profile_fn(lambda: step(*batches[1]))
        else:
            opt_cls = torch.optim.Adam if opt == "adam" else torch.optim.SGD
            step = training.make_train_step(model, opt_cls(
                model.parameters(), lr=1e-4))
        ms = train_step_ms(step, batches)
        log(f"resnet18 training {opt} step B=32: {ms:.2f} ms, "
            f"{32e3 / ms:.1f} img/s ({smi})")
    argv = r18("swag") + TRAIN_R18_OPTS["sgd"] + ["--swag"] \
        + TRAIN_R18_SWAG_RANK
    cli(training, argv, "resnet18 training sgd --swag")
    argv += ["--estimator", "swag", "--bn_update", "--ood"] \
        + TRAIN_SWAG_DAMPING
    probs, bnn_probs, labels = cli(evaluate, argv,
                                   "resnet18 evaluate swag --bn_update --ood")
    with np.load(results_paths(parse_args(argv))[0] + ".npz",
                 allow_pickle=True) as f:
        auroc, ood = f["auroc"], f["bnn_ood_predictions"]
    for what, p in (("nn", probs), ("bnn", bnn_probs), ("bnn ood", ood)):
        if p.shape != (256, 10) or not np.isfinite(p).all() \
                or np.abs(p.sum(1) - 1).max() > 1e-3:
            raise AssertionError(f"resnet18 swag {what} predictions "
                                 "malformed")
    log(f"resnet18 swag --bn_update --ood: NN {accuracy(probs, labels):.2f}%"
        f", BNN {accuracy(bnn_probs, labels):.2f}%; AUROC NN {auroc[0]:.4f}"
        f" BNN {auroc[1]:.4f}")
    cfg = parse_args(r18("sgd"))
    model = common.build_model(cfg)
    counters.reset()
    res, seconds = timed(lambda: loss_landscape.loss1d(
        model, common.build_data(cfg, "train"), common.build_data(cfg, "val"),
        torch.Generator(device=dev).manual_seed(cfg.seed),
        steps=LANDSCAPE_R18_POINTS))
    if counters.read() != none or not np.isfinite(res["train_loss"]).all():
        raise AssertionError(f"resnet18 loss1d: launches {counters.read()}")
    points = 2 * LANDSCAPE_R18_POINTS
    log(f"resnet18 loss1d at full width: {points} points (train, 512 "
        f"images, and val, 256) in {seconds:.3f} s, {seconds / points:.4f} "
        f"s per point ({smi})")
    log(f"training phase: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return by_path


def lm_tokens(rng, n, dev):
    """n seeded [LM_BATCH, LM_T] token batches and [LM_BATCH, LM_T] label
    batches on the card."""
    import torch
    out = []
    for _ in range(n):
        x = rng.integers(0, LM_VOCAB, (LM_BATCH, LM_T)).astype("int32")
        y = rng.integers(0, LM_VOCAB, (LM_BATCH, LM_T)).astype("int64")
        out.append((torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)))
    return out


def timed(fn):
    """(fn(), wall seconds), synchronized on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


def token_stats(stats, what):
    """Accuracy, ECE and NLL per token from the [N, 4] STATS_COLUMNS,
    after checking them finite."""
    import numpy as np
    from curvature_tpu_torch.eval import metrics
    if not np.isfinite(stats).all():
        raise AssertionError(f"{what}: stats not finite")
    return {"acc": 100.0 * float(stats[:, 2].mean()),
            "ece": 100.0 * float(metrics.ece_from_confidence(
                stats[:, 1], stats[:, 2])[0]),
            "nll": float(-np.log(np.clip(stats[:, 0], 1e-12, None)).mean())}


def lm_tail(est, model, x, y, gen, counters, label, samples):
    """invert at LM_DAMPING -> one sample -> a ``samples``-sample per-token
    BNN eval (``eval_bnn_stats``, drawn 10 at a time) on one batch; no
    Gram kernel launched; every step's wall seconds printed."""
    from curvature_tpu_torch.eval import eval_bnn_stats
    _, inv_s = timed(lambda: est.invert(*LM_DAMPING))
    check_finite(est.inv_state, f"{label} inv_state")
    sample, sample_s = timed(lambda: est.sample(generator=gen))
    check_finite(sample, f"{label} sample")
    counters.reset()
    (stats, _), eval_s = timed(lambda: eval_bnn_stats(
        model, est, [(x, y.cpu().numpy())], samples, generator=gen,
        sample_chunk=10))
    if counters.read() != counters.zero():
        raise AssertionError(f"{label}: eval launched {counters.read()}")
    log(f"{label}: invert{LM_DAMPING} {inv_s:.3f} s; sample {sample_s:.3f} "
        f"s; {samples}-sample per-token bnn eval of {x.numel()} tokens "
        f"{eval_s:.3f} s: {json.dumps(token_stats(stats, label))} (random "
        "weights)")


def lm_updates(est, batches, gen, counters, label):
    """``update`` over ``batches`` with the counters set to 0 just before
    and read just after: no Gram kernel may launch."""
    counters.reset()
    _, seconds = timed(lambda: [est.update(x, generator=gen)
                                for x, _ in batches])
    got = counters.read()
    log(f"{label}: {len(batches)} updates in {seconds:.3f} s; launches "
        f"{json.dumps(got)}")
    if got != counters.zero():
        raise AssertionError(f"{label}: Gram kernels launched: {got}")
    check_finite(est.state, f"{label} state")


def lm_phase(estimators, models, counters, smi, dev, profile=False):
    """The causal-LM path on GPT-2 124M (seeded N(0, 0.02) weights in
    JAX's layout, carried across by ``models.load_jax_variables``): (a)
    KFAC over the stacked blocks at B=8, T=512 -- the rate, invert,
    sample, a 30-sample per-token eval, and depth slices against the
    unrolled model; (b) last-layer KFAC on the 50,257-word head with
    blocked G; (c) Diagonal, KFAC, EFB and INF over 4 batches, Block on
    gpt2_tiny's stacked ``h.attn.c_proj``; (d) the ``--data tokens`` CLIs.
    Returns the rate."""
    import os
    import numpy as np
    import torch
    from curvature_tpu_torch.pipelines import evaluate, factors
    from curvature_tpu_torch.utils.checkpoint import results_paths
    from curvature_tpu_torch.utils.config import parse_args
    none = counters.zero()
    rng = np.random.default_rng(11)
    gen = torch.Generator(device=dev).manual_seed(12)
    model = models.gpt2(LM_VOCAB, scan_blocks=True, max_len=LM_T, device=dev)
    variables = models.seeded_variables(model, 0)
    models.load_jax_variables(model, variables)
    batches = lm_tokens(rng, 1 + LM_UPDATES, dev)

    # (a) the main path: KFAC over the blocks, the rate by bench.py's method
    est = estimators.KFAC(model, loss="lm", layer_filter="h.*")
    lm_updates(est, batches[:1], gen, counters, f"{LM_PATH} (warm update)")
    best = float("inf")
    for _ in range(3):
        counters.reset()
        _, seconds = timed(lambda: [est.update(x, generator=gen)
                                    for x, _ in batches[1:]])
        if counters.read() != none:
            raise AssertionError(f"{LM_PATH}: launches {counters.read()}")
        best = min(best, seconds)
    rate = LM_BATCH * LM_T * LM_UPDATES / best
    check_finite(est.state, f"{LM_PATH} state")
    log(f"{LM_PATH}: {rate:.2f} tokens/s (GPT-2 124M depth-stacked, f32, "
        f"B={LM_BATCH} T={LM_T} MC=1, layers h.*, best of 3 blocks of "
        f"{LM_UPDATES} updates: {1e3 * best / LM_UPDATES:.1f} ms per update;"
        f" {smi})")
    state_gb = sum(t.numel() * t.element_size() for f in est.state.values()
                   for t in f.values()) / 1e9
    log(f"{LM_PATH}: KFAC state {state_gb:.3f} GB; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        log(f"{LM_PATH} (one update):")
        profile_update(est, batches[0][0], gen)
    x, y = batches[0]
    lm_tail(est, model, x, y, gen, counters, "gpt2 124M kfac", SAMPLES)
    del est
    # depth slice i of the stacked factors == the unrolled model's h.{i}
    flat = models.gpt2(LM_VOCAB, max_len=LM_T, device=dev)
    models.load_jax_variables(flat,
                              models.unstack_scan_groups(variables, model))
    one = {}
    for what, m in (("scan", model), ("unrolled", flat)):
        e = estimators.KFAC(m, loss="lm", layer_filter="h.*")
        e.update(x, labels=y)
        one[what] = e.state
    worst = {"a": 0.0, "g": 0.0}
    for name, fac in one["scan"].items():
        for i in range(fac["a"].shape[0]):
            flat_fac = one["unrolled"][name.replace("h.", f"h.{i}.", 1)]
            for key in worst:
                worst[key] = max(worst[key],
                                 rel_err(fac[key][i], flat_fac[key]))
    log(f"stacked slices vs the unrolled model, one batch: A "
        f"{worst['a']:.3e} (bar 1e-5), G {worst['g']:.3e} (bar 1e-4) of max")
    if worst["a"] > 1e-5 or worst["g"] > 1e-4:
        raise AssertionError(f"stacked vs unrolled factors: {worst}")
    del one, flat

    # (b) the vocabulary head: last-layer KFAC with blocked G
    head = estimators.KFAC(model, loss="lm", layer_filter="last",
                           g_block_size=LM_G_BLOCK)
    meta = head.metas["lm_head"]
    nb, bs, padded = head._gblock_dims(meta)
    counters.reset()
    cap = head.capture(x, labels=y)
    head._accumulate(cap)
    if counters.read() != none:
        raise AssertionError(f"lm_head update launched {counters.read()}")
    g = head.state["lm_head"]["g"]
    got = float(torch.diagonal(g, dim1=-2, dim2=-1).double().sum())
    grads = cap.probe_grads["lm_head"].double()
    n_tok = grads[0].numel() // meta.out_features
    want = float((grads ** 2).sum()) * cap.batch_size ** 2 / n_tok
    del cap, grads
    tail = meta.out_features - (nb - 1) * bs
    tail_nz = int(torch.count_nonzero(g[-1, tail:, :])
                  + torch.count_nonzero(g[-1, :, tail:]))
    log(f"lm_head blocked G: {nb} blocks of [{bs}, {bs}] ({padded} padded "
        f"rows); sum of block traces {got:.9e} vs B^2/N sum |g_n|^2 "
        f"{want:.9e}: rel {abs(got - want) / abs(want):.3e} (bar 1e-5); "
        f"nonzeros in the padded tail {tail_nz}")
    if abs(got - want) > 1e-5 * abs(want) or tail_nz:
        raise AssertionError("lm_head blocked G check failed")
    lm_tail(head, model, x, y, gen, counters, "lm_head kfac (blocked G)", 2)
    del head

    # (c) the ladder over the stacked 124M layers, the same 4 batches
    ladder_batches = batches[:LM_LADDER_BATCHES]
    diag = estimators.Diagonal(model, loss="lm", layer_filter="h.*")
    lm_updates(diag, ladder_batches, gen, counters, "gpt2 ladder diagonal")
    lm_tail(diag, model, x, y, gen, counters, "gpt2 ladder diagonal",
            LM_LADDER_SAMPLES)
    kfac = estimators.KFAC(model, loss="lm", layer_filter="h.*")
    lm_updates(kfac, ladder_batches, gen, counters, "gpt2 ladder kfac")
    lm_tail(kfac, model, x, y, gen, counters, "gpt2 ladder kfac",
            LM_LADDER_SAMPLES)
    efb, eig_s = timed(lambda: estimators.EFB(model, kfac.state, loss="lm",
                                              layer_filter="h.*"))
    shapes = sorted({tuple(f[k].shape) for f in kfac.state.values()
                     for k in "ag"})
    log(f"gpt2 ladder efb: eigendecomposition of {2 * len(efb.metas)} "
        f"stacked factors ({shapes}) in {eig_s:.3f} s")
    lm_updates(efb, ladder_batches, gen, counters, "gpt2 ladder efb")
    lm_tail(efb, model, x, y, gen, counters, "gpt2 ladder efb",
            LM_LADDER_SAMPLES)
    counters.reset()
    inf = estimators.INF(model, efb.diags, kfac.state, efb.state,
                         eigvecs=efb.eigvecs, layer_filter="h.*")
    _, build_s = timed(lambda: inf.update(
        rank=INF_RANK, max_product=LM_INF_MAX_PRODUCT, bucket=INF_BUCKET))
    if counters.read() != none:
        raise AssertionError(f"INF build launched {counters.read()}")
    sizes = {n: [s["ua"].shape[-1], s["ug"].shape[-1]]
             for n, s in inf.state.items()}
    log(f"gpt2 ladder inf: update(rank={INF_RANK}, max_product="
        f"{LM_INF_MAX_PRODUCT}, bucket={INF_BUCKET}) in {build_s:.3f} s; "
        f"(L, M) per depth by layer {json.dumps(sizes)}")
    check_finite(inf.state, "gpt2 ladder inf state")
    lm_tail(inf, model, x, y, gen, counters, "gpt2 ladder inf",
            LM_LADDER_SAMPLES)
    del diag, kfac, efb, inf
    tiny = models.gpt2_tiny(scan_blocks=True, max_len=64, device=dev)
    models.load_jax_variables(tiny, models.seeded_variables(tiny, 0))
    tb = [(torch.from_numpy(rng.integers(0, 256, (8, 64)).astype("int32"))
           .to(dev), torch.from_numpy(rng.integers(0, 256, (8, 64))).to(dev))
          for _ in range(LM_LADDER_BATCHES)]
    blk = estimators.BlockDiagonal(tiny, loss="lm",
                                   layer_filter="h.attn.c_proj")
    lm_updates(blk, tb, gen, counters,
               "gpt2_tiny ladder block (h.attn.c_proj, stacked)")
    lm_tail(blk, tiny, tb[0][0], tb[0][1], gen, counters,
            "gpt2_tiny ladder block", LM_LADDER_SAMPLES)
    del blk, tiny

    # (d) the --data tokens CLIs on gpt2_tiny
    root = os.path.abspath(os.path.join(PIPE_ROOT, "gpt2_tiny"))
    base = LM_ARGV + ["--root_dir", root, "--results_dir", root]
    for name in ("diag", "kfac", "efb", "inf"):
        est, got = run_cli(factors, base + ["--estimator", name], counters,
                           smi, f"gpt2_tiny tokens factors {name}")
        if got != none:
            raise AssertionError(f"gpt2_tiny factors {name} launched {got}")
        check_finite(est.state, f"gpt2_tiny {name} state")
    for name in ("kfac", "efb"):
        argv = base + ["--estimator", name, "--ood"] + LM_CLI_DAMPING
        (probs, bnn_probs, labels), got = run_cli(
            evaluate, argv, counters, smi,
            f"gpt2_tiny tokens evaluate {name} --ood")
        cfg = parse_args(argv)
        with np.load(results_paths(cfg)[0] + ".npz",
                     allow_pickle=True) as f:
            auroc = f["auroc"]
        for what, p in (("nn", probs), ("bnn", bnn_probs)):
            if p.shape != (256 * cfg.seq_len, 256) \
                    or not np.isfinite(p).all() \
                    or np.abs(p.sum(1) - 1).max() > 1e-3:
                raise AssertionError(f"gpt2_tiny {name} {what} malformed")
        if got != none or not np.isfinite(auroc).all():
            raise AssertionError(f"gpt2_tiny evaluate {name}: {got}, "
                                 f"AUROC {auroc}")
        log(f"gpt2_tiny tokens {name} --ood (random weights): NN accuracy "
            f"{100 * np.mean(probs.argmax(1) == labels):.2f}%, BNN "
            f"{100 * np.mean(bnn_probs.argmax(1) == labels):.2f}% per "
            f"token; AUROC NN {auroc[0]:.4f} BNN {auroc[1]:.4f}")
    root = os.path.abspath(os.path.join(PIPE_ROOT, "gpt2_tiny_vocab"))
    base = LM_VOCAB_ARGV + ["--root_dir", root, "--results_dir", root,
                            "--estimator", "kfac"]
    est, got = run_cli(factors, base, counters, smi,
                       "gpt2_tiny vocab 50257 factors kfac (h.*)")
    check_finite(est.state, "gpt2_tiny vocab kfac state")
    (nn_s, bnn_s, labels), got2 = run_cli(
        evaluate, base + ["--ood"] + LM_CLI_DAMPING, counters, smi,
        "gpt2_tiny vocab 50257 evaluate kfac --ood (stats route)")
    n_tok = 256 * parse_args(base).seq_len
    if got != none or got2 != none or nn_s.shape != (n_tok, 4) \
            or bnn_s.shape != (n_tok, 4):
        raise AssertionError(f"gpt2_tiny vocab: {got}, {got2}, "
                             f"{nn_s.shape}, {bnn_s.shape}")
    log(f"gpt2_tiny vocab 50257 per-token stats: NN "
        f"{json.dumps(token_stats(nn_s, 'nn'))}, BNN "
        f"{json.dumps(token_stats(bnn_s, 'bnn'))}")
    return rate


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a device-time breakdown of one update "
                         "of each path")
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels, print their records "
                         "and the f32 sym_gram split sweep (SPLIT_SWEEP), "
                         "and stop (no paths, no result line)")
    ap.add_argument("--lm", action="store_true",
                    help="build the kernels, run the causal-LM phase only "
                         "and stop (no result line)")
    ap.add_argument("--grouped", action="store_true",
                    help="build the kernels, run the grouped-conv phase "
                         "only and stop (no result line)")
    ap.add_argument("--hyper", action="store_true",
                    help="build the kernels, write the factor files the "
                         "damping-search phase reads, run that phase only "
                         "and stop (no result line)")
    ap.add_argument("--training", action="store_true",
                    help="build the kernels, run the training phase only "
                         "and stop (no result line)")
    ap.add_argument("--zoo", action="store_true",
                    help="build the kernels, run the classic-zoo phase "
                         "only and stop (no result line)")
    ap.add_argument("--transformers", action="store_true",
                    help="build the kernels, run the vision-transformer "
                         "phase only and stop (no result line)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from curvature_tpu_torch import estimators, models
        from curvature_tpu_torch.eval import eval_nn
        from curvature_tpu_torch.ops.cuda import build
        from curvature_tpu_torch.ops.cuda import patch_gram as tpg
        from curvature_tpu_torch.ops.cuda import sym_gram as tsg
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2

    # strict f32 wherever parity is checked (cuDNN convs default to TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"card: {torch.cuda.get_device_name(0)}")
    log(smi)

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    reports = build.build_all(force=True)
    log(f"build: {time.perf_counter() - t0:.2f} s for "
        f"{sorted(reports)} (nvcc -gencode arch=compute_90a,code=sm_90a, "
        "one process per source)")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                        "spill", "wgmma", "arning")):
                log(f"  {name}: {line.strip()}")
    hgmma = hgmma_counts(build)
    if args.hyper:
        t0 = time.perf_counter()
        r50 = hyper_inputs(estimators, models, Counters(tpg, tsg), smi, dev)
        log(f"hyper inputs (factor files, ResNet-50 updates): "
            f"{time.perf_counter() - t0:.1f} s")
        hyper_phase(Counters(tpg, tsg), smi, dev, r50)
        log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            " GiB")
        return 0
    if args.grouped:
        t0 = time.perf_counter()
        grouped_phase(estimators, models, Counters(tpg, tsg), smi,
                      torch.device("cuda", 0), args.profile)
        log(f"grouped phase: {time.perf_counter() - t0:.1f} s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return 0
    if args.training:
        training_phase(estimators, Counters(tpg, tsg), smi, dev,
                       args.profile)
        log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            " GiB")
        return 0
    if args.zoo:
        t0 = time.perf_counter()
        zoo_phase(estimators, models, Counters(tpg, tsg), smi, dev,
                  args.profile)
        log(f"zoo phase: {time.perf_counter() - t0:.1f} s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return 0
    if args.transformers:
        t0 = time.perf_counter()
        transformer_phase(estimators, models, Counters(tpg, tsg), smi, dev,
                          args.profile)
        log(f"transformer phase: {time.perf_counter() - t0:.1f} s; peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({smi})")
        return 0
    if args.lm:
        lm_phase(estimators, models, Counters(tpg, tsg), smi,
                 torch.device("cuda", 0), args.profile)
        log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            " GiB")
        return 0

    # -- 2. kernels against their plain versions ----------------------------
    t_section = time.perf_counter()
    log("kernels vs plain versions:")
    records = []
    for dtype in ("f32", "bf16"):
        records += check_patch_kernels(tpg, dtype)
        records += check_sym_kernel(tsg, dtype)
    for rec in records:
        fam = "sym" if rec["function"] == "sym_gram" else "patch"
        mod = tsg if fam == "sym" else tpg
        edge = mod.BF16_TILE if rec["dtype"] == "bf16" else mod.F32_TILE
        kernel = KERNEL_OF[fam, rec["dtype"]]
        if rec["dtype"] == "f32":
            how = f"3xTF32 wgmma m64n{edge}k8 on tf32 tensor cores"
        else:
            how = f"wgmma m64n{edge}k16 on bf16 tensor cores"
        rec["tile"] = f"{edge}x{edge}, {how}"
        rec["hgmma_in_sass"] = {fn: n for fn, n in hgmma.items()
                                if kernel in fn}
    if args.kernels:
        add_device_times(records)
        print(json.dumps({"split_sweep": sweep_sym_splits(tsg)}))
        print(json.dumps({"kernels": records}))
        return 0

    log(f"kernel checks: {time.perf_counter() - t_section:.1f} s ({smi})")

    # -- 3. the paths ---------------------------------------------------------
    t_section = time.perf_counter()
    model = models.resnet50(num_classes=CLASSES, device=dev)
    models.load_jax_variables(model, models.seeded_variables(model, 0))
    model = model.to(memory_format=torch.channels_last)
    rng = np.random.default_rng(1)
    batches = [x for x, _ in nchw_batches(rng, UPDATES, BATCH, dev)]
    test_data = nchw_batches(rng, 2, BATCH, dev)
    batches_b32 = [x for x, _ in nchw_batches(rng, UPDATES, BATCH_B32, dev)]
    gen = torch.Generator(device=dev).manual_seed(2)
    counters = Counters(tpg, tsg)
    none = counters.zero()
    by_path = {}

    # 3a. f32: the KFAC Laplace loop
    est = estimators.KFAC(model)
    if not est.use_kernels:
        raise AssertionError("use_kernels='auto' must enable the kernels "
                             "on CUDA")
    by_path[PATHS[0]] = drive_updates(
        est, batches, gen, counters, PATHS[0],
        dict(none, patch_gram_tiled=3 * UPDATES, patch_gram_v2=UPDATES))
    ensemble, _ = laplace_tail(est, model, test_data, gen, counters, "kfac")
    counters.reset()
    nn_probs, labels = eval_nn(model, test_data)
    if counters.read() != counters.zero():
        raise AssertionError(f"eval_nn launched {counters.read()}")
    log(f"nn metrics (random weights, {2 * BATCH} synthetic images): "
        f"{json.dumps(prob_stats(nn_probs, labels, 'nn'))}")

    # 3b. bf16 at B=32: layer2.0.conv2 through the v2 kernel in bf16
    est16 = estimators.KFAC(model, compute_dtype=torch.bfloat16)
    by_path[PATHS[1]] = drive_updates(
        est16, batches_b32, gen, counters, PATHS[1],
        dict(none, patch_gram_v2=UPDATES))

    # 3c. bf16 with token_subsample=0.25 at B=16: no Gram kernel
    est_sub = estimators.KFAC(model, compute_dtype=torch.bfloat16,
                              token_subsample=0.25)
    by_path[PATHS[2]] = drive_updates(est_sub, batches, gen, counters,
                                      PATHS[2], none)

    # 3d. the estimator ladder: Diagonal, EFB from the f32 path's factors,
    # INF from both, BlockDiagonal on DENSE_LAYER; no Gram kernel
    lad = ladder(estimators, model, est, batches, test_data, gen, counters)

    log(f"resnet50 paths and ladder: {time.perf_counter() - t_section:.1f} s"
        f" ({smi})")
    # 3e. the pipeline CLIs: LeNet-5 on the digits, ResNet-18 on synthetic
    t_section = time.perf_counter()
    r18_paths, r18_updated = pipelines(estimators, counters, smi)
    log(f"pipeline phase: {time.perf_counter() - t_section:.1f} s ({smi})")
    by_path.update(r18_paths)

    # 3f. the damping search and the predictives on those factor files, and
    # on the f32 ResNet-50 factors of 3a
    hyper_phase(counters, smi, dev, (model, est, test_data))

    # 3g. training, the KFAC optimizer, SWAG, the loss landscape
    by_path.update(training_phase(estimators, counters, smi, dev,
                                  args.profile))

    for rec in records:
        # a record's shapes are ResNet-50's or ResNet-18's: it counts the
        # launches of its wrapper on that network's paths of its dtype (the
        # zoo's records count the zoo's paths, below)
        base = rec["name"].split("_bf16")[0]
        r18 = base.endswith("_resnet18")
        paths = (() if base in ZOO_RECORD_PATHS
                 or base in TRANSFORMER_RECORD_PATHS else
                 (R18_PATHS[:1] + (TRAIN_PATH,) if rec["dtype"] == "f32"
                  else R18_PATHS[1:])
                 if r18 else
                 (PATHS[:1] if rec["dtype"] == "f32" else PATHS[1:]))
        rec["launches_by_path"] = {
            p: by_path[p][rec["counter"]] if p in paths else 0
            for p in PATHS + R18_PATHS + (TRAIN_PATH,)}
        rec["launches"] = sum(rec["launches_by_path"].values())

    # -- 4. is what came out right? -----------------------------------------
    t_section = time.perf_counter()
    # the kernels' A factors against use_kernels=False on the same capture
    checked = ["layer1.0.conv2", "layer2.0.conv2"]
    for name in checked:
        a_factor_check(est, estimators.KFAC(
            model, use_kernels=False, layer_filter=checked),
            batches[-1], name, "f32")
    a_factor_check(est16, estimators.KFAC(
        model, use_kernels=False, compute_dtype=torch.bfloat16,
        layer_filter=["layer2.0.conv2"]),
        batches_b32[-1], "layer2.0.conv2", "bf16, B=32")
    # bf16 factors against f32 ones from one batch with the same labels
    one = {}
    for what, kw in (("f32", {}), ("bf16", {"compute_dtype": torch.bfloat16})):
        e = estimators.KFAC(model, **kw)
        e.update(batches[0], labels=torch.arange(BATCH, device=dev))
        one[what] = e.state
    worst = {"a": 0.0, "g": 0.0}
    for name, fac in one["f32"].items():
        for key in worst:
            want, got = fac[key], one["bf16"][name][key]
            rel = float((got - want).abs().max() / want.abs().max())
            worst[key] = max(worst[key], rel)
            if key == "a" and rel > BF16_RTOL:
                raise AssertionError(f"{name}: bf16 A factor {rel:.3e} of "
                                     f"max from the f32 one (> {BF16_RTOL})")
    log(f"bf16 vs f32 factors, one batch, worst over layers: "
        f"A {worst['a']:.3e} (bar {BF16_RTOL}), G {worst['g']:.3e}")
    # all five estimators on DENSE_LAYER against their float64 precision
    dense_check(estimators, model, batches, gen)

    # -- 5. rates --------------------------------------------------------------
    rates = {PATHS[0]: best_rate(est, batches, gen, BATCH),
             PATHS[1]: best_rate(est16, batches_b32, gen, BATCH_B32),
             PATHS[2]: best_rate(est_sub, batches, gen, BATCH)}
    bnn_img_s = eval_rate(model, est, test_data, ensemble)
    for path, what in zip(PATHS, (f"f32 B={BATCH}", f"bf16 B={BATCH_B32}",
                                  f"bf16 token_subsample=0.25 B={BATCH}")):
        log(f"{path}: {rates[path]:.2f} update img/s (ResNet-50 {what} "
            f"MC=1, best of 3 blocks of {UPDATES} updates; {smi})")
    log(f"resnet50_bnn30_eval_img_s: {bnn_img_s:.2f} (best of 3 blocks of "
        f"{2 * BATCH} images x {SAMPLES} samples; {smi})")
    # the ladder's rates: informative lines, no benchmark metric
    for kind, (e, ens) in lad.items():
        if kind != "inf":                  # INF runs no update pass
            log(f"ladder {kind}: {best_rate(e, batches, gen, BATCH):.2f} "
                f"update img/s (f32 B={BATCH} MC=1, best of 3 blocks of "
                f"{UPDATES} updates; {smi})")
        log(f"ladder {kind}: {eval_rate(model, e, test_data, ens):.2f} bnn30 "
            f"eval img/s (best of 3 blocks of {2 * BATCH} images x "
            f"{SAMPLES} samples; {smi})")
    log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    add_device_times(records)
    log(f"checks, rates and device times: "
        f"{time.perf_counter() - t_section:.1f} s ({smi})")
    if args.profile:
        for path, e, b in zip(PATHS, (est, est16, est_sub),
                              (batches, batches_b32, batches)):
            log(f"{path}:")
            profile_update(e, b[0], gen)
        for kind in ("diagonal", "efb", "block"):
            log(f"ladder {kind} (f32 B={BATCH}):")
            profile_update(lad[kind][0], batches[0], gen)
        for path, e, x in r18_updated:
            log(f"{path} (the pipeline's update: B=32, MC={PIPE_MC}):")
            profile_update(e, x, gen, num_samples=PIPE_MC)

    # -- 6. grouped and depthwise convolutions: ResNeXt-50, EfficientNet-B0,
    # ConvNeXt-T, the MobileNetV2 CLIs -------------------------------------
    del est, est16, est_sub, lad, r18_updated, ensemble
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    grouped_by_path = grouped_phase(estimators, models, counters, smi, dev,
                                    args.profile)
    log(f"grouped phase: {time.perf_counter() - t0:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for rec in records:
        # the grouped paths launch none of the kernels (JAX's routes)
        rec["launches_by_path"].update(
            {p: got[rec["counter"]] for p, got in grouped_by_path.items()})
        rec["launches"] = sum(rec["launches_by_path"].values())
    torch.cuda.empty_cache()

    # -- 7. the classic zoo: DenseNet-121 and the other torchvision CNNs,
    # the CIFAR-10 -> SVHN CLI chain from a .pth, the regression cell ----
    t0 = time.perf_counter()
    zoo_by_path = zoo_phase(estimators, models, counters, smi, dev,
                            args.profile)
    log(f"zoo phase: {time.perf_counter() - t0:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    count_record_launches(records, zoo_by_path, ZOO_RECORD_PATHS)
    torch.cuda.empty_cache()

    # -- 8. the vision transformers: ViT-B/16, Swin-T, MaxViT-T, the CLIs --
    t0 = time.perf_counter()
    tr_by_path = transformer_phase(estimators, models, counters, smi, dev,
                                   args.profile)
    log(f"transformer phase: {time.perf_counter() - t0:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    count_record_launches(records, tr_by_path, TRANSFORMER_RECORD_PATHS)
    torch.cuda.empty_cache()

    # -- 9. the causal-LM path: GPT-2 124M, the ladder, the token CLIs -----
    t0 = time.perf_counter()
    lm_phase(estimators, models, counters, smi, dev, args.profile)
    log(f"lm phase: {time.perf_counter() - t0:.1f} s ({smi})")
    log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"whole run: {time.perf_counter() - t_start:.1f} s")

    log(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def count_record_launches(records, by_path, record_paths):
    """Each record's launches on a phase's paths: a record named in
    ``record_paths`` counts its counter on its paths there, every other
    record 0; raises unless every launch of a phase stands under exactly
    one record."""
    counted = {}
    for rec in records:
        mine = record_paths.get(rec["name"], ())
        rec["launches_by_path"].update(
            {p: got[rec["counter"]] if p in mine else 0
             for p, got in by_path.items()})
        rec["launches"] = sum(rec["launches_by_path"].values())
        for p in mine:
            key = (p, rec["counter"])
            counted[key] = counted.get(key, 0) + by_path[p][rec["counter"]]
    for p, got in by_path.items():
        for counter in ("patch_gram_tiled", "patch_gram_v2"):
            if got[counter] != counted.get((p, counter), 0):
                raise AssertionError(f"{p}: {got[counter]} {counter} "
                                     "launches under no kernel record")


def profile_update(est, x, gen, num_samples=1):
    """Device time of one update by kernel name (torch.profiler), and the
    device-busy share of the update's wall time."""
    profile_fn(lambda: est.update(x, generator=gen,
                                  num_samples=num_samples), "update")


def profile_fn(fn, what="step"):
    """Device time of one call of ``fn`` (after a warm call) by kernel
    name (torch.profiler), and the device-busy share of its wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device kernels only: an aten op's row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 1e3    # ms
    log(f"profile: one {what} {wall * 1e3:.1f} ms wall, "
        f"{busy:.1f} ms of device kernels ({100 * busy / (wall * 1e3):.1f}%"
        f" of the wall time), {sum(e.count for e in events)} launches")
    for e in events[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


if __name__ == "__main__":
    sys.exit(main())
