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
    python3 chip_smoke.py --grams      # builds the kernels, checks and
                                       # times the batched f32 sym_gram at
                                       # the fit cells' shapes, sweeps its
                                       # gate, counts its launches an
                                       # update on the fit models
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
    python3 chip_smoke.py --subspace   # builds the kernels, runs the
                                       # exact-curvature phase only (with
                                       # --profile: one Subspace update
                                       # too)
    python3 chip_smoke.py --moe        # builds the kernels, runs the
                                       # mixture-of-experts phase only
                                       # (with --profile: one update of
                                       # the full-width MoE GPT-2 too)
    python3 chip_smoke.py --parallel   # builds the kernels, runs the
                                       # parallel phase only (a world of
                                       # one over NCCL, two gloo ranks)
    python3 chip_smoke.py --images     # builds the kernels and the
                                       # image decoders, runs the
                                       # image-folder phase only
    python3 chip_smoke.py --surface    # builds the kernels, runs the
                                       # public-surface phase only, then
                                       # the ensemble routes' sweep

It builds the CUDA kernels from ``curvature_tpu_torch/ops/cuda/csrc``,
counts the tensor-core (HGMMA) instructions of each kernel in their SASS
(every tile kernel must have them, the f32 pre-pass and the reduces
none), holds each kernel (patch_gram_tiled, patch_gram_v2, patch_gram,
sym_gram with its f32 pre-pass, corr_gram; f32 and bf16) against its plain
PyTorch version on the card, including cases whose blocks each sum a full
``MAX_CHAIN_TOKENS`` chain (and corr_gram against its float64 Gram, at a
bar a single TF32 pass fails), then drives
three paths of ResNet-50 (ImageNet stem, 1000 classes, 224x224, MC=1,
seeded weights), named after ``bench.py``'s rows:

  * ``resnet50_kfac_update_img_s``: the KFAC Laplace loop in f32 at B=16,
    4 factor updates (each 3 tiled + 1 v2 + 16 corr_gram launches), split-damped inversion, a 30-sample posterior
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

Then the image-folder loaders (``images_phase``, ROADMAP item 9): the
decoders built with g++ beside the CUDA kernels, every committed fixture
decoded on the card's host and held to PIL's decode (``expected.npz``, 0
pixels off) and the committed JAX loader batches bit for bit, one
thread's decode and load ms per ImageNet-shaped JPEG,
``ParallelDecodeLoader``'s img/s, then under ``build/images`` an
ImageNet-style tree of fixture copies: ``factors`` on ResNet-50 at 224²
from the JPEG folder (3 tiled + 1 v2 + 16 corr an update, its loop and
update calls timed), ``evaluate --ood`` to the art folder and ``factors
--data gtsrb`` on PPMs (8 + 1 an update).

Then the figures (``figures_phase``, ROADMAP item 7): the files that the
``--plot`` CLIs above wrote under JAX's names (ResNet-18's five OOD
panels for kfac and efb, LeNet-5's FGSM sweep and random search, the
training phase's loss landscapes, ResNet-50's OOD panels from the JPEG
folder), then ``visualize`` over the three roots with every figure
toggle and ``--summary``; each file must pass ``utils/pdf.read_pdf``,
show its labels and paint at least its series or bars. It prints the
files, their bytes, the phase's seconds (``FIG_BUDGET_S``) and the
slowest figure's.

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

Then the exact curvature (``subspace_phase``) on ResNet-18 CIFAR at full
width, B=128: the rows of JAX's ``subspace_swag_pipeline``
(``resnet18_subspace_update_rank32_b128``, ``resnet18_subspace_invert``,
``resnet18_subspace_sample30``, ``resnet18_swag_collect_b128``,
``resnet18_swag_sample30``), sketch columns against ``ggn_matvec``, the
solve against the quadratic form, a Lanczos check, the ``factors
--fidelity --spectrum`` (its KFAC fit launching ``R18_ROUTES``' kernels),
``factors``/``evaluate``/``hyper --estimator subspace`` CLIs under
``build/subspace``, and ``self_influence`` under KFAC; no running
statistic may move. Then the causal-LM phase.

Last the mixture-of-experts phase (``moe_phase``): the Switch GPT-2 at
GPT-2 124M's width with 8 two-layer experts a block, unrolled, through
KFAC (``gpt2_moe_124m_e8_kfac_update_tok_s``, invert, a sample, a short
per-token eval), each expert's routed share and an expert A factor
against float64; JAX ``benchmarks/suite.py``'s MoE row
(``gpt2_moe_kfac_update_tok_s``, ``gpt2_moe_kfac_invert_s``,
``gpt2_moe_expert_factor_blocks`` = 64); KFAC's ``stack_grams`` and
``fused_g``, each alone and both, against the default on the unrolled
GPT-2 124M and on ResNet-50 (the same factors, the same launches, the ms
per update); the ``gpt2_moe_tiny --data tokens`` CLIs under
``build/moe``; and the ``moe_laplace`` example. None of it launches a
Gram kernel but ResNet-50's updates, by JAX's routes.

Then the parallel phase (``parallel_phase``, ROADMAP item 10a): a world
of one over NCCL, where the ResNet-50 f32 B=16 KFAC update through
``use_mesh(data:1)`` must equal the single path's (``PAR_ONE_RTOL``;
3 tiled + 1 v2 + 16 corr launches) and both update rates are printed, and the
ResNet-18 ``factors --parallel`` CLI under ``build/parallel`` must write
its plain run's file; then two gloo ranks on the one card, this script
spawned twice (``--parallel_rank``), whose ResNet-18 CIFAR KFAC factors
at global B=32 (on ``data:2``, BatchNorm synced, and on ``sample:2``) must
equal one process's at JAX's bar, whose Diagonal on ``data:2`` must come
within ``PAR_DIAG64_TOL`` of max of one float64 process's, whose launches
must be the routes of their shapes, and whose meshed ``eval_bnn`` must
give one process's ECE and NLL. Each rank's update wall time and collective
share are printed.

Every failed check raises. The last line of standard output is the
``{"ok": true, ...}`` JSON object; the line before it is the ``kernels``
JSON object. It exits non-zero, printing no result, where there is no
CUDA device or where the package is not beside it.
"""
import argparse
import atexit
import concurrent.futures
import contextlib
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
#: corr_gram launches of one ResNet-50 update at 224², any batch, f32 or
#: bf16: two a call (products, assemble) in each of the 8 layers that take
#: the correlation route (stride 1, 3x3, C >= 128, extent >= 14):
#: layer2.1-3.conv2 at 28² and layer3.1-5.conv2 at 14²; none where
#: token_subsample < 1 closes that route
R50_CORR = 2 * 8
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
#: batched symmetric kernel launches a KFAC update of GPT-2 124M's stacked
#: blocks at B=8, T=512: its 8 factor Grams, each past the gate
LM_SYM = 8
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
#: the mixture-of-experts phase: the Switch GPT-2 at GPT-2 124M's
#: width (vocabulary, context, B as the LM phase), E=8 two-layer experts a
#: block (hidden 3,072), unrolled (MoE cannot ride a ScanBlocks stack),
#: f32, MC=1, 'h.*'; the rate's blocks of updates cut to 2, the per-token
#: eval to 4 samples (the script's clock)
MOE_PATH = "gpt2_moe_124m_e8_kfac_update_tok_s"
MOE_WIDTH = (768, 12, 12)                  # dim, depth, heads
MOE_EXPERTS, MOE_UPDATES, MOE_SAMPLES = 8, 2, 4
#: the expert A factor held against float64, and its bar (of max)
MOE_CHECKED, MOE_RTOL = "h.0.moe.fc1", 1e-5
#: JAX benchmarks/suite.py:392-428's MoE row: the model, B, T; 4 updates a
#: block; its count of per-expert factor blocks (4 blocks x 2 layers x 8)
MOE_SUITE = dict(vocab=1024, dim=256, depth=4, heads=4, experts=8,
                 max_len=256)
MOE_SUITE_BATCH, MOE_SUITE_UPDATES, MOE_SUITE_BLOCKS = 8, 4, 64
#: KFAC's options against the default (ROADMAP Queue 1 item 2): each alone
#: and both, on the unrolled GPT-2 124M and on ResNet-50 f32 B=16
MOE_OPTIONS = ({"stack_grams": True}, {"fused_g": True},
               {"stack_grams": True, "fused_g": True})
MOE_OPTION_RTOL = 1e-5
MOE_ROOT = "build/moe"
MOE_ARGV = ["--model", "gpt2_moe_tiny", "--data", "tokens", "--seq_len",
            "16", "--batch_size", "32", "--mc_samples", "1", "--samples", "4"]
#: the damping-search phase (JAX pipelines/hyper.py, its objectives and
#: the predictives): the LeNet-5 searches as (estimator, flags); --layer
#: evaluates ~170 candidates, at 4 samples each (23.3 s of the phase at
#: the default 30, 9.4 s at 10)
HYPER_LENET = (("kfac", ["--optimizer", "random", "--calls", "16",
                         "--boundaries", "--plot"]),
               ("kfac", ["--optimizer", "grid"]),
               ("diag", ["--optimizer", "gp", "--calls", "12"]),
               ("efb", ["--optimizer", "forest", "--calls", "10"]),
               ("kfac", ["--optimizer", "gbrt", "--calls", "10"]),
               ("kfac", ["--layer", "--calls", "4", "--samples", "4"]))
HYPER_LENET_MARGLIK = (["--optimizer", "gp", "--calls", "12"],
                       ["--optimizer", "grad", "--calls", "100"],
                       ["--optimizer", "grad", "--calls", "100", "--layer"])
#: ResNet-18: the sampled searches' calls and samples, the evidence's
#: searches, the predictives of evaluate --ood. Its gradient ascent runs
#: as the 20 timed steps of marglik_gradient_tune below: the CLI's
#: (at least 100 steps; its path runs on LeNet-5 above) took 11.5-11.8 s
#: and was cut to make room for the images phase
HYPER_R18 = ["--optimizer", "random", "--calls", "8", "--samples", "10"]
HYPER_R18_MARGLIK = (["--optimizer", "gp", "--calls", "12"],)
HYPER_PREDICTIVES = ("probit", "bridge", "linearized", "linearized_probit")
#: evaluate --predictive's posterior samples (the CLI's default is 30: a
#: linearized run at 30 took 16-18 s of the phase's time, at 10 8.6-9.0 s
#: on a slow host)
HYPER_PREDICTIVE_SAMPLES = ["--samples", "4"]
#: the predictives' rates: test batches of 32 timed (the first 64 of the
#: 256 test images; the linearized predictive runs ~34-48 img/s: 128
#: images took 6.6 s with the warm-up run, cut for the images phase)
HYPER_RATE_BATCHES = 2
#: the LeNet-5 FGSM sweeps (at the blitz's and the searched dampings, and
#: SWAG's) take 4 posterior samples: at 30 each cost 13-17 s, at 10
#: 5.6-8.2 s on a slow host
FGSM_CHAIN_SAMPLES = ["--samples", "4"]
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
#: the grouped, zoo and transformer phases' evaluate --ood CLIs take 10
#: posterior samples (at the CLI's default 30 each took 4.6-8.8 s)
OOD_CLI_SAMPLES = ["--samples", "10"]
GROUPED_INF_RANK = "50"
#: the zoo phase (the reference's torchvision CNNs, reference
#: factors.py:80-84): DenseNet-121 at 224², ImageNet head, f32 B=16
#: through the ResNet-50 row's KFAC loop (bench.py), under its names
ZOO_PATHS = ("densenet121_kfac_update_img_s",
             "densenet121_kfac_update_bf16_sub4_img_s")
#: its rates' blocks (best of 3): 2 updates each (~1.3 s an f32 update
#: at B=16) and one test batch of BATCH images x SAMPLES samples
ZOO_RATE_UPDATES, ZOO_EVAL_BATCHES = 2, 1
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
#: (tiled, v2, corr) A routes of one f32 update by JAX's routes, per
#: (model, batch, extent): the tiled and v2 counts held against JAX's
#: dispatch by tests/test_torch_zoo_classic_layers.py; each corr layer
#: (the 3x3 convs over 128 or more channels at 14² or more: DenseNet's
#: bottlenecked denseblocks 1-3, VGG-16's conv2_2 to conv5_3, GoogLeNet's
#: four widest 3x3 branches) launches corr_gram twice
ZOO_ROUTES = {("densenet121", 16, 224): (16, 0, 42),
              ("densenet121", 32, 32): (58, 0, 0),
              ("densenet161", 8, 224): (0, 0, 54),
              ("vgg16", 8, 224): (2, 0, 10),
              ("inception_v3", 8, 299): (10, 27, 0),
              ("googlenet", 8, 224): (9, 0, 4),
              ("alexnet", 8, 224): (0, 0, 0),
              ("squeezenet1_1", 8, 224): (6, 0, 0)}
#: VGG-16's classifier.0 has fan-in 25,088: its A factor (25,089 wide,
#: 2.5 GB in f32) is past KFAC's default max_factor_dim of 16,384
ZOO_MAX_FACTOR_DIM = 25089
#: the CLI chain on array-format files this phase writes: a CIFAR-10
#: pickle tree (5 batches of ZOO_CIFAR_TRAIN training images, 256 test),
#: an SVHN test .mat of 256 (the OOD pair), a torchvision-layout
#: densenet121_cifar10.pth; factors kfac (5 updates of 32 through
#: DevicePrefetcher, cut from 10 for the run's budget) -> evaluate --ood
ZOO_ROOT = "build/zoo"
ZOO_CIFAR_TRAIN, ZOO_TEST = 32, 256
ZOO_ARGV = ["--model", "densenet121", "--data", "cifar10", "--batch_size",
            "32"]
ZOO_CLI_UPDATES = 5
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
    "patch_gram_v2_inception_v3": ("inception_v3_kfac_update",),
    "corr_gram": (ZOO_PATHS[0], "densenet161_kfac_update", "vgg16_kfac_update",
                  "googlenet_kfac_update")}
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
#: (tiled, v2, corr) A routes of one f32 MaxViT-T update at 224², B=16:
#: stem.1.0 (3x3 s1, C=64 at 112²); none in bf16 (the tiled and v2
#: counts held against JAX's dispatch by
#: tests/test_torch_zoo_transformers.py); no corr layer (64 channels)
MAXVIT_ROUTES = (1, 0, 0)
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
#: the exact-curvature phase (JAX benchmarks/suite.py:509-561,
#: subspace_swag_pipeline): ResNet-18 CIFAR (10 classes, 32², seeded
#: weights) at B=128, the Nyström sketch at rank 32 (suite.py's names),
#: SWAG at JAX's rank 20; the sketch's vmapped columns in chunks of
#: SUB_CHUNK (None: all 32 in one vmap)
SUB_PATHS = ("resnet18_subspace_update_rank32_b128",
             "resnet18_synthetic_factors_kfac_fidelity",
             "resnet18_self_influence_kfac")
SUB_BATCH, SUB_RANK, SUB_CHUNK, SUB_SWAG_RANK = 128, 32, None, 20
#: the checks' bars: a sketch column against one matvec, and
#: quadratic_form(solve(d)) against <d, solve(d)>
SUB_RTOL = 1e-4
#: Lanczos steps of the phase's check, and the damping of its posterior
#: (a prior standard deviation of 0.01 outside the sketch's 32 directions,
#: against He-init scales of 0.02-0.08)
SUB_LANCZOS, SUB_DAMPING = 16, (1e4, 1e4)
#: the CLIs under their own root: R18_ARGV's 16 batches of 32; the KFAC
#: fit behind --fidelity launches R18_ROUTES' kernels, the rest none
SUB_ROOT = "build/subspace"
SUB_FIDELITY = ["--fidelity", "4", "--spectrum", "16"]
SUB_HYPER = ["--optimizer", "random", "--calls", "3", "--samples", "4"]
#: self-influence of SUB_INFLUENCE training examples under a KFAC fitted
#: on 4 batches of 32 (R18_ROUTES' launches each)
SUB_INFLUENCE = 64
#: kernel record -> the exact-curvature paths whose f32 launches it counts
SUB_RECORD_PATHS = {"patch_gram_tiled_resnet18": SUB_PATHS[1:],
                    "patch_gram_v2_resnet18": SUB_PATHS[1:]}
#: the parallel phase: the world of one over NCCL (ResNet-50 f32, B=16,
#: through use_mesh), the ResNet-18 factors CLI with --parallel and its
#: plain reference, and each of the two gloo ranks' update (ResNet-18
#: CIFAR f32, global B=32, data:2)
PAR_PATHS = ("resnet50_kfac_update_mesh_data1",
             "resnet18_synthetic_factors_kfac_f32_parallel",
             "resnet18_synthetic_factors_kfac_f32_plain",
             "resnet18_kfac_update_gloo_data2_rank0",
             "resnet18_kfac_update_gloo_data2_rank1")
PAR_RECORD_PATHS = {"patch_gram_tiled": PAR_PATHS[:1],
                    "patch_gram_v2": PAR_PATHS[:1],
                    "corr_gram": PAR_PATHS[:1],
                    "patch_gram_tiled_resnet18": PAR_PATHS[1:],
                    "patch_gram_v2_resnet18": PAR_PATHS[1:]}
PAR_ROOT = "build/parallel"
#: the world of one against the single path: max|diff| over max|factor|
#: (identity is expected: the same kernels on the same tokens)
PAR_ONE_RTOL = 1e-6
#: the gloo ranks: JAX's sharding bar (tests/test_sharding.py), rtol 1e-5
#: and an absolute 1e-6 of max|factor|
PAR_RTOL, PAR_ATOL = 1e-5, 1e-6
#: the ranks' Diagonal against one float64 process, every layer: max|diff|
#: at most this of max|factor|. Diagonal squares each weight's batch
#: gradient, an f32 sum over 16,384-32,768 positions that cancels for some
#: weights, so JAX's elementwise bar against one f32 process does not hold
#: on the card (layer1's convs up to 3.696e-5 of max); one f32 process
#: itself read up to 2.230e-5 of max from a float64 one. The bar is about
#: twice that reading
PAR_DIAG64_TOL = 5e-5
#: ResNet-18 CIFAR on 2 ranks: the global batch, its MC draws (injected,
#: [2, 32]), the test images and ensemble members of the meshed eval
PAR_WORLD, PAR_BATCH, PAR_MC, PAR_TEST, PAR_SAMPLES = 2, 32, 2, 64, 4
#: the meshed eval's damping: the ResNet-18 CLIs' (R18_DAMPING)
PAR_DAMPING = (1e4, 1e4)
#: the meshed eval's ECE and NLL against one process's
PAR_EVAL_TOL = 1e-6
#: the world of one's rates: best of 3 blocks of this many updates a side
PAR_RATE_UPDATES = 2
#: the parallel phase's budget and the plain run's (seconds): each run
#: prints its time against them (the contract's limit is 1200 s; the
#: budgets leave room for hosts ~40% slower than the card's typical one)
PAR_BUDGET_S, RUN_BUDGET_S = 45.0, 540.0
#: the mesh-axes phase (the model, tensor, seq and expert axes): one job
#: of two gloo ranks on the card runs one KFAC f32 update of each path on
#: its mesh (injected labels), then invert(MA_DAMPING) and one sample; the
#: parent holds each to one process's. GPT-2 124M's width (dim 768, 12
#: heads, vocabulary 50,257) at B=8, T=512, its depth cut from 12 to
#: MA_DEPTH and the Switch GPT-2's to MA_MOE_DEPTH (time: five one-process
#: references and a float64 witness in the parent, then the ranks' gloo)
MA_PATHS = {"switch_gpt2_e8_kfac_update_expert2": ("moe", {"expert": 2}),
            "gpt2_124m_scan_kfac_update_model2": ("scan", {"model": 2}),
            "gpt2_124m_kfac_update_tensor2": ("gpt", {"tensor": 2}),
            "gpt2_124m_kfac_update_seq2": ("gpt", {"seq": 2}),
            "lenet5_kfac_update_seq2": ("lenet", {"seq": 2}),
            "resnet18_kfac_update_seq2": ("resnet18", {"seq": 2})}
MA_WORLD, MA_DEPTH, MA_MOE_DEPTH, MA_EXPERTS = 2, 4, 2, 8
MA_BATCH, MA_T, MA_LENET_BATCH = 8, 512, 32
MA_DAMPING, MA_NOISE_SEED = (1.0, 10.0), 17
MA_ROOT = "build/mesh_axes"
#: the mesh-axes phase's launches stand under the records of their
#: wrapper at ResNet-18's shapes (on each seq rank its row blocks, routed
#: by the whole input); GPT-2 and LeNet-5 launch none
MA_RECORD_PATHS = {f"{c}_resnet18": tuple(
    f"resnet18_kfac_update_seq2_rank{r}" for r in range(2))
    for c in ("patch_gram_tiled", "patch_gram_v2")}
#: the phase's budget (seconds)
MA_BUDGET_S = 60.0
#: the image-folder phase (data/images.py, the loaders, the folder CLIs):
#: the committed fixtures decoded on the card's host and held to PIL's
#: decodes (expected.npz), then an ImageNet-style tree of fixture copies
#: under IMG_ROOT (train: 4 classes x 64 of the six ImageNet-shaped JPEGs,
#: val: 32 of every format, art: 2 classes x 16) and a GTSRB one (PPM, 4
#: unbalanced classes), and the CLIs on them: ResNet-50 at 224² (ImageNet
#: stem, 1000 classes, seeded weights) KFAC f32 B=16 MC=1, evaluate --ood
#: (imagenet -> art), ResNet-18 on --data gtsrb at 32², B=32
IMG_ROOT = "build/images"
IMG_PATHS = ("resnet50_imagenet_folder_factors_kfac_f32",
             "resnet18_gtsrb_folder_factors_kfac_f32")
IMG_RECORD_PATHS = {"patch_gram_tiled": IMG_PATHS[:1],
                    "patch_gram_v2": IMG_PATHS[:1],
                    "corr_gram": IMG_PATHS[:1],
                    "patch_gram_tiled_resnet18": IMG_PATHS[1:],
                    "patch_gram_v2_resnet18": IMG_PATHS[1:]}
IMG_TRAIN, IMG_VAL, IMG_ART, IMG_GTSRB = (4, 64), 32, (2, 16), (
    20, 6, 4, 2)
IMG_ARGV = ["--model", "resnet50", "--data", "imagenet", "--batch_size",
            str(BATCH), "--mc_samples", "1", "--estimator", "kfac"]
GTSRB_ARGV = ["--model", "resnet18", "--data", "gtsrb", "--batch_size",
              "32", "--mc_samples", "1", "--estimator", "kfac"]
#: ResNet-50 f32 B=16 at 224²: (tiled, v2, corr) A routes an update
#: (PATHS[0]; R50_CORR)
IMG_ROUTES = (3, 1, R50_CORR // 2)
#: the threads of the ParallelDecodeLoader rate, and the phase's budget
#: (seconds)
IMG_WORKERS, IMG_BUDGET_S = 8, 40.0
#: the figures phase (pipelines/plot.py, utils/figure.py, utils/pdf.py):
#: the --plot CLIs above (ResNet-18's evaluate --ood for kfac and efb,
#: LeNet-5's evaluate --fgsm, the LeNet-5 random search, the training
#: phase's --loss1d/--loss2d, ResNet-50's evaluate --ood to the art
#: folder) wrote their figures under JAX's names; visualize draws over
#: their roots with every figure toggle. A figure's suffix -> (what its
#: text must show, an entry ending in ': ' a prefix; the least paths it
#: paints: its series, points, bars or faces)
FIG_KINDS = {
    "_ecdf.pdf": (("Predictive entropy", "1 - ECDF", "NN OOD", "BNN OOD"),
                  4),
    "_reliability.pdf": (("Confidence", "Accuracy", "Gap", "ECE: "), 21),
    "_entropy.pdf": (("Predictive entropy", "in-domain", "OOD", "JSD: "),
                     78),
    "_fgsm.pdf": (("FGSM step size", "Accuracy [%]", "ECE [%]", "Entropy",
                   "NN", "BNN"), 6),
    "_hyper.pdf": (("log10 norm", "log10 scale", "cost"), 17),
    "_loss1d.pdf": (("alpha", "Loss", "Accuracy [%]"), 4),
    "_loss2d.pdf": (("alpha", "beta"), 400),
    "_calibration.pdf": (("Confidence", "Accuracy", "NN", "BNN-KFAC"), 4),
    "_networks.pdf": (("Confidence", "Accuracy"), 4),
    "_eigvals.pdf": (("log10 eigenvalue", "Count", "KFAC"), 60),
}
#: the five figures of evaluate --ood --plot (JAX plot.ood_panels)
FIG_OOD = ("_ecdf.pdf", "_reliability.pdf", "_bnn_reliability.pdf",
           "_entropy.pdf", "_bnn_entropy.pdf")
FIG_BUDGET_S = 15.0
#: the public-surface phase (ROADMAP Queue 1, the JAX package's exported
#: names): the tutorial's LeNet-5 (its train and test digits, B=32,
#: 10 MC labels an update, 30 samples), its invert settings (the
#: pipeline's blitz damping; INF at rank 100 the tutorial's own), the
#: ResNet-50 ensemble of the vmapped eval (f32, B=16, 30 members) held to
#: a member loop within SURF_ENSEMBLE_TOL of max |p|, and its budget
SURF_DAMPING = {"Diagonal": (1.0, 5e4), "KFAC": (1.0, 5e4),
                "EFB": (1.0, 5e4), "INF": (1e15, 1e20)}
SURF_INF_RANK, SURF_MC, SURF_SAMPLES = 100, 10, 30
SURF_ENSEMBLE_TOL, SURF_BUDGET_S = 1e-4, 40.0
SURF_ROOT = "build/surface"
#: the surface phase's kernel path: the ResNet-18 update profile_trace
#: records, and the kernel records its launches count under
SURF_PATHS = ("resnet18_kfac_update_traced",)
SURF_RECORD_PATHS = {"patch_gram_tiled_resnet18": SURF_PATHS,
                     "patch_gram_v2_resnet18": SURF_PATHS}
#: --surface's sweep of the ensemble's two routes, what sets
#: VMAP_MAX_PIXELS in eval/evaluate.py: (registry name, constructor
#: keywords, batch, image sides), SAMPLES members, f32, TF32 off
SWEEP_CASES = (("resnet50", {}, BATCH, (32, 64, 96, 128, 224)),
               ("resnet18", {"stem": "cifar"}, 32, (32, 64)),
               ("densenet121", {}, BATCH, (64, 224)),
               ("vit_b_16", {}, BATCH, (224,)))
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
    "corr_gram": "no Pallas kernel: curvature_tpu/ops/corr_gram.py is plain "
                 "XLA; on CUDA, the torch composition of ops/corr_gram.py",
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
    the shares of the split reduce, the f32 pre-pass and the correlation
    Gram's assemble in it (and that Gram's device time at each of its
    shapes). Run after the paths: a profiler run slows the host's later
    launches."""
    for rec in records:
        by_kernel = device_ms_by_kernel(rec.pop("call"))
        rec["device_ms_by_kernel"] = by_kernel
        rec["device_ms"] = sum(by_kernel.values())
        for part in ("reduce", "presplit", "assemble"):
            rec[f"device_ms_{part}"] = sum(
                v for k, v in by_kernel.items() if f"{part}_kernel" in k)
        for key, fn in rec.pop("calls_by_shape", {}).items():
            rec["by_shape"][key]["device_ms"] = sum(
                device_ms_by_kernel(fn).values())
        log(f"{rec['name']}: {rec['ms']:.4f} ms, device {rec['device_ms']:.4f}"
            f" ms ({rec['gather']} gather; {rec['tile']}), plain "
            f"{rec['plain_ms']:.4f}, library {rec['library_ms']:.4f} / f32 "
            f"out {rec['library_f32_out_ms']}, bound {rec['bound_ms']:.4f} "
            f"({rec['bound_by']}); by kernel " + ", ".join(
                f"{k} {v:.4f}" for k, v in rec["device_ms_by_kernel"].items()))
        for key, t in rec.get("by_shape", {}).items():
            log(f"  {rec['name']} {key}: {t['ms']:.4f} ms a call (host "
                f"{t['host_ms']:.4f}), device {t['device_ms']:.4f} ms, "
                f"plain {t['plain_ms']:.4f} ms; {t['blocks']} blocks of "
                f"{t['items']} rectangles")


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
             ("sym", "bf16"): "sym_wgmma_kernel",
             ("corr", "f32"): "corr_tf32x3_wgmma_kernel",
             ("corr", "bf16"): "corr_tf32x3_wgmma_kernel"}


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
    for name in ("patch_gram", "sym_gram", "corr_gram"):
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
                      + (f"{name}.cu" if name in ("sym_gram", "corr_gram")
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
    from curvature_tpu_torch.ops.cuda.launch import MAX_CHAIN_TOKENS
    shape, ks, pad, st = CHAIN_CASE
    x = torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(tdt)
    n = shape[0] * shape[1] * shape[2]
    per_split = -(-n // patch_splits(tpg, x, ks, pad, st))
    if per_split != MAX_CHAIN_TOKENS:
        raise AssertionError(f"chain case: {per_split} tokens a split, not "
                             f"{MAX_CHAIN_TOKENS}")
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


#: ResNet-50's correlation-route shapes at B=128 (layer2.1-3.conv2 and
#: layer3.1-5.conv2, 3x3 SAME); the first is the record's shape
CORR_CASES = [((128, 28, 28, 128), (3, 3), "SAME"),
              ((128, 14, 14, 256), (3, 3), "SAME")]
#: the correlation Gram against its float64 value: the worst error of an
#: off-diagonal entry over the largest off-diagonal entry. The diagonal
#: (and max|G|) grows as the tokens, an off-diagonal sum and the rounding
#: of any sum as their square root, so a bar of max|G| loses sight of a
#: lower precision as N grows, and this one does not. On the card the
#: kernel read at most 1.09e-6 (f32, tests/test_torch_corr_gram.py's
#: shapes and CORR_CASES), the same Grams of operands rounded to TF32 (a
#: single TF32 pass) at least 2.75e-4 and of bf16 operands 2.27e-3
CORR_OFF_RTOL = 1e-5


def corr_flops(shape, kernel_size):
    """The correlation Gram's FLOP: 2 * N * C^2 * (2 kh kw - kh - kw + 1)
    (2k^2 - 2k + 1 full-field products for a k x k kernel)."""
    b, h, w, c = shape
    k2 = kernel_size[0] * kernel_size[1]
    taps = 2 * k2 - kernel_size[0] - kernel_size[1] + 1
    return 2 * b * h * w * c * c * taps


def gram64(x, kernel_size, pads):
    """The [F+1, F+1] patch Gram with its ones column, in float64, from the
    unfolded patch matrix (an oracle independent of both routes)."""
    import torch
    import torch.nn.functional as F
    (pt, pb), (pl, pr) = pads
    xp = F.pad(x.double().permute(0, 3, 1, 2), (pl, pr, pt, pb))
    p = F.unfold(xp, kernel_size)
    p = p.transpose(1, 2).reshape(-1, p.shape[1])
    p = torch.cat([p, p.new_ones(p.shape[0], 1)], 1)
    return p.T @ p


def off_diagonal_err(got, ref):
    """The largest off-diagonal |got - ref| over the largest off-diagonal
    |ref|."""
    import torch
    off = ~torch.eye(ref.shape[0], dtype=torch.bool, device=ref.device)
    return float((got.double() - ref)[off].abs().max()
                 / ref[off].abs().max())


def tf32_round(x):
    """``x`` rounded to TF32 (10 mantissa bits, to nearest): the operands
    of a single TF32 pass."""
    import torch
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def check_corr_kernel(ccg, tcorr, dtype):
    """The correlation Gram's kernel on CORR_CASES in ``dtype``: two
    launches a call, the same bits from a second call, within GRAM_RTOL of
    the composition and within CORR_OFF_RTOL of the float64 Gram off the
    diagonal, where (in f32) a single TF32 pass and bf16 operands must
    fail that bar.
    Each shape timed (CUDA events over back-to-back calls, the host's
    enqueue time a call, the composition's time); the record is the
    first shape's, its bound the 3xTF32 one of corr_flops. Returns the
    records."""
    import numpy as np
    import torch
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(3)
    worst, by_shape, calls, main = 0.0, {}, {}, None
    for shape, ks, pad in CORR_CASES:
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda().to(tdt)
        pads = ccg.resolve_padding(pad, shape[1], shape[2], ks)
        before = ccg.corr_gram.launches
        got = _launch_twice(ccg.corr_gram, x, ks, pad)
        launches = (ccg.corr_gram.launches - before) / 2
        want = tcorr.corr_patch_gram_plain(x, ks, pad)
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        ref = gram64(x, ks, pads)
        off = off_diagonal_err(got, ref)
        controls = {} if dtype == "bf16" else {
            "tf32_1x": off_diagonal_err(gram64(tf32_round(x), ks, pads),
                                        ref),
            "bf16_operands": off_diagonal_err(
                gram64(x.bfloat16(), ks, pads), ref)}
        del ref
        log(f"  corr_gram {dtype} {shape} k={ks} {pad}: {launches:.0f} "
            f"launches a call, rel={rel:.3e} (composition), off-diagonal "
            f"{off:.3e} (float64; bar {CORR_OFF_RTOL})" + "".join(
                f", {k} {v:.3e}" for k, v in controls.items()))
        if not (torch.isfinite(got).all() and rel <= GRAM_RTOL
                and off <= CORR_OFF_RTOL and launches == 2):
            raise AssertionError(f"corr_gram {dtype} {shape}: rel {rel:.3e}"
                                 f", off-diagonal {off:.3e}, {launches} "
                                 "launches")
        if any(v <= CORR_OFF_RTOL for v in controls.values()):
            raise AssertionError(f"corr_gram {shape}: a lower precision "
                                 f"passes the bar: {controls}")
        worst = max(worst, rel)
        plan = ccg.make_plan(*shape, ks, pads, ccg._resident_blocks(
            0, dtype == "bf16", ccg.vector_gather(x)))
        call = functools.partial(ccg.corr_gram, x, ks, pad)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        key = "x".join(map(str, shape))
        by_shape[key] = {
            "ms": cuda_ms(call), "host_ms": host_ms,
            "plain_ms": cuda_ms(lambda: tcorr.corr_patch_gram_plain(
                x, ks, pad)),
            "max_rel_err": rel, "off_diagonal_err": off,
            "controls_off_diagonal_err": controls,
            "blocks": len(plan.blocks), "items": len(plan.items),
            "max_tokens_a_block": max(plan.per_split)}
        calls[key] = call
        if main is None:
            main = (x, ks, pads, abs_err, rel, call, corr_flops(shape, ks))
    x, ks, pads, abs_err, rel, call, flops = main
    rec = _record(
        "corr_gram", dtype, x.shape, abs_err, rel, worst, len(CORR_CASES),
        gather="vector" if ccg.vector_gather(x) else "scalar",
        ms=by_shape["x".join(map(str, x.shape))]["ms"], call=call,
        plain_ms=by_shape["x".join(map(str, x.shape))]["plain_ms"],
        **bounds(flops, x.numel() * x.element_size()
                 + (x.shape[-1] * ks[0] * ks[1] + 1) ** 2 * 4, "f32"),
        **time_yardsticks(dtype, lambda: unfold(x, ks, pads, (1, 1))))
    rec.update(flops=flops, launches_per_call=2, by_shape=by_shape,
               calls_by_shape=calls)
    return [rec]


def check_sym_chain(tsg, tdt, rng):
    """SYM_CHAIN_CASE through ``sym_gram``: every block sums exactly its
    chain cap of tokens (f32 MAX_CHAIN_TOKENS, flushing its tensor-core
    accumulator into an f32 total; bf16 BF16_CHAIN_TOKENS, unflushed).
    Returns its error, rel to max(max|G|, 1)."""
    import numpy as np
    import torch
    from curvature_tpu_torch.ops.cuda.launch import MAX_CHAIN_TOKENS
    n, f = SYM_CHAIN_CASE
    bf16 = tdt == torch.bfloat16
    cap = tsg.BF16_CHAIN_TOKENS if bf16 else MAX_CHAIN_TOKENS
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(
        np.float32)).cuda().to(tdt)
    splits, per_split = sym_splits(tsg, x)
    if per_split != cap or splits * per_split != n:
        raise AssertionError(f"sym chain case: {splits} splits of "
                             f"{per_split} tokens, not of {cap}")
    return check_sym_case(tsg, x, "bf16" if bf16 else "f32")[1]


def sweep_sym_splits(tsg):
    """SPLIT_SWEEP through the f32 ``sym_gram``, each shape launched with
    one split and with the wave-filling count (the wrapper's f32 plan,
    ``_batched_plan``, replaced for the sweep): device ms of each
    (pre-pass, tile kernel and any reduce), every result checked against
    the plain version."""
    import numpy as np
    import torch
    from curvature_tpu_torch.ops.cuda.launch import (
        MAX_CHAIN_TOKENS, split_count)
    rng = np.random.default_rng(2)
    plan, rows = tsg._batched_plan, []
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
            fill = max(split_count(n, tiles, slots),
                       -(-n // MAX_CHAIN_TOKENS))
            for key, splits in (("one", 1), ("fill", fill)):
                per = -(-(-(-n // splits)) // tsg.CHUNK) * tsg.CHUNK
                tsg._batched_plan = lambda *_, p=per: (-(-n // p), p)
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
        tsg._batched_plan = plan
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
    if counters.read() != counters.want():
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
    return sum(len(y) for _, y in test_data) / best


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
    if counters.read() != counters.want(none):
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


def sym_launches(tsg, spans):
    """The batched symmetric kernel's launches that ``spans`` record: one a
    slice of MAX_SEGMENTS segments of each Gram that a ``factor`` span
    says took it (its ``gram_shape``) or a ``stack_grams`` span lists (its
    ``gram_shapes``); raises where such a (segments, rows, F) is under
    the gate, or a ``sym`` span gives no shape."""
    n = 0
    for s in spans:
        if s.name == "stack_grams":
            shapes = s.attrs.get("gram_shapes", [])
        elif s.name == "factor" and s.attrs.get("gram") == "sym" \
                and s.attrs.get("route") != "stack_grams":
            shapes = [s.attrs["gram_shape"]]
        else:
            continue
        for segments, rows, f in shapes:
            if not tsg.batched_gate(segments, rows, f):
                raise AssertionError(f"a Gram under the gate took the "
                                     f"batched kernel: {s}")
            n += -(-segments // tsg.MAX_SEGMENTS)
    return n


class Counters:
    """The kernel wrappers' launch counters, as {name: (wrapper,
    attribute)}. Spans record from construction on: :meth:`read` holds
    the batched symmetric kernel's counter to the count that the spans
    since the last :meth:`reset` give (:func:`sym_launches`), and
    :meth:`want` completes an expectation with it."""

    def __init__(self, tpg, tsg):
        from curvature_tpu_torch.ops.cuda import corr_gram as ccg
        from curvature_tpu_torch.utils import monitor
        self.fns = {"patch_gram_tiled": (tpg.patch_gram_tiled, "launches"),
                    "patch_gram_v2": (tpg.patch_gram_v2, "launches"),
                    "patch_gram_v2_any_stride": (tpg.patch_gram_v2,
                                                 "any_stride_launches"),
                    "patch_gram": (tpg.patch_gram, "launches"),
                    "sym_gram": (tsg.sym_gram, "launches"),
                    "tf32_presplit": (tsg.tf32_presplit, "launches"),
                    "corr_gram": (ccg.corr_gram, "launches"),
                    "sym_gram_batched": (tsg.sym_gram_batched, "launches")}
        self.tsg, self.monitor = tsg, monitor
        self.tracing = contextlib.ExitStack()
        self.tracing.enter_context(monitor.tracing())
        atexit.register(self.tracing.close)
        self.last_sym = 0

    def reset(self):
        for fn, attr in self.fns.values():
            setattr(fn, attr, 0)
        self.monitor.clear_spans()

    def read(self):
        got = {name: getattr(fn, attr)
               for name, (fn, attr) in self.fns.items()}
        if self.monitor.dropped_spans():
            raise AssertionError("the span buffer overflowed")
        want = sym_launches(self.tsg, self.monitor.spans())
        if got["sym_gram_batched"] != want:
            raise AssertionError(f"sym_gram_batched launched "
                                 f"{got['sym_gram_batched']} times, the "
                                 f"factor spans' Grams give {want}")
        self.last_sym = want
        return got

    def zero(self):
        """No launch of any counter but the batched kernel's, whose count
        :meth:`want` fills in."""
        return {name: 0 for name in self.fns if name != "sym_gram_batched"}

    def want(self, expect=None, got=None):
        """``expect`` (default :meth:`zero`) with the batched kernel's
        count where it gives none: ``got``'s (default the last read's),
        which :meth:`read` held to the spans'."""
        expect = dict(self.zero() if expect is None else expect)
        expect.setdefault("sym_gram_batched", self.last_sym if got is None
                          else got["sym_gram_batched"])
        return expect


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
    if got != counters.want(expect, got):
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
        if got != counters.want(none, got) or est.num_updates != LENET_UPDATES:
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
    (stats, bnn_stats), got = run_cli(evaluate, kfac_argv + ["--fgsm",
                                                             "--plot"]
                                      + FGSM_CHAIN_SAMPLES, counters, smi,
                                      "lenet5 evaluate kfac --fgsm --plot")
    if got != counters.want(none, got):
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
        if got != counters.want(want, got) or est.num_updates != R18_UPDATES:
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
        if got != counters.want(none, got):
            raise AssertionError(f"resnet18 {name} launched {got}")
        check_finite(est.state, f"resnet18 {name} state")
    est, _ = run_cli(factors, base + ["--estimator", "inf", "--rank", "100"],
                     counters, smi, "resnet18 factors inf (rank 100)")
    check_finite(est.state, "resnet18 inf state")
    for name in ("kfac", "efb"):
        argv = base + ["--estimator", name, "--ood", "--plot"] + R18_DAMPING
        (probs, bnn_probs, labels), got = run_cli(
            evaluate, argv, counters, smi,
            f"resnet18 evaluate {name} --ood --plot")
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
        if got != counters.want(none, got) or not np.isfinite(auroc).all():
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
    if got != counters.want(got=got) or not np.isfinite(out["best_cost"]):
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
        if counters.read() != counters.want(none):
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
    if got != counters.want(none, got) or bnn_stats["acc"][0] <= 50.0:
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
        if got != counters.want(none, got) or not np.isfinite(auroc).all():
            raise AssertionError(f"resnet18 --predictive {kind}: launches "
                                 f"{got}, AUROC {auroc}")
    est.invert(*(float(v) for v in R18_DAMPING[1::2]))
    test = list(common.on_device(common.build_data(cfg, "test"), dev))
    test = test[:HYPER_RATE_BATCHES]
    n_test = sum(len(y) for _, y in test)
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
        rates[name] = round(n_test / timed(fn)[1], 2)
    log(f"resnet18 predictive rates, img/s ({SAMPLES}-sample ensemble, "
        f"{n_test} images, after a warm-up run; {smi}): "
        f"{json.dumps(rates)}")
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
        if counters.read() != counters.want(none):
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
        if counters.read() != counters.want(none):
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
        if got != counters.want(none, got):
            raise AssertionError(f"mobilenet_v2 factors {name}: {got}")
        check_finite(est.state, f"mobilenet_v2 {name} state")
    for name in ("kfac", "inf"):
        argv = base + ["--estimator", name, "--ood", "--rank",
                       GROUPED_INF_RANK] + R18_DAMPING + OOD_CLI_SAMPLES
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
        if got != counters.want(none, got) or not np.isfinite(auroc).all():
            raise AssertionError(f"mobilenet_v2 evaluate {name}: launches "
                                 f"{got}, AUROC {auroc}")
    return by_path


def kernel_route_check(est, plain_kw, x, expect, what):
    """The (tiled, v2, corr) counts of ``est``'s A routes on ``x`` (one
    capture's input shapes) must be ``expect``; then every kernel-routed
    layer's A factor from that capture against a ``use_kernels=False``
    KFAC's (``plain_kw`` its other arguments), and every corr layer's Gram
    against the torch composition, under GRAM_RTOL: the kernels held
    against their plain versions at the shapes the path gives them.
    Returns the worst error, rel to max."""
    import torch
    from curvature_tpu_torch.ops import corr_gram as tcorr
    cap = est.capture(x, labels=torch.zeros(x.shape[0], dtype=torch.long,
                                            device=x.device))
    routes = {n: est.a_route(m, cap.acts[n].shape,
                             cap.acts[n].element_size())
              for n, m in est.metas.items()}
    kinds = ("tiled", "v2", "corr")
    counts = tuple(list(routes.values()).count(r) for r in kinds)
    if counts != tuple(expect):
        raise AssertionError(f"{what}: (tiled, v2, corr) routes {counts}, "
                             f"want {tuple(expect)}")
    names = [n for n, r in routes.items() if r in kinds]
    patch = [n for n in names if routes[n] != "corr"]
    plain = est.__class__(est.model, use_kernels=False, layer_filter=patch,
                          **plain_kw) if patch else None
    worst = 0.0
    for name in names:
        act, meta = cap.acts[name], est.metas[name]
        if routes[name] == "corr":
            args = (act, meta.kernel_size, meta.padding, meta.has_bias)
            got = tcorr.corr_patch_gram(*args)
            want = tcorr.corr_patch_gram_plain(*args)
        else:
            got = est._a_factor(meta, act)
            want = plain._a_factor(plain.metas[name], act)
        rel = float((got - want).abs().max() / want.abs().max())
        worst = max(worst, rel)
        if not (torch.isfinite(got).all() and rel <= GRAM_RTOL):
            raise AssertionError(
                f"{what} {name} ({routes[name]}, input "
                f"{tuple(act.shape)}): A factor rel err {rel:.3e}")
    if names:
        shapes = sorted({(routes[n], tuple(cap.acts[n].shape),
                          est.metas[n].kernel_size) for n in names})
        log(f"{what}: {len(names)} kernel-routed A factors vs "
            f"use_kernels=False and the corr composition, worst rel "
            f"{worst:.3e} (bar {GRAM_RTOL}); (route, input, kernel): "
            f"{shapes}")
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

    def launches(tiled, v2, corr, n=1):
        return dict(none, patch_gram_tiled=tiled * n, patch_gram_v2=v2 * n,
                    corr_gram=2 * corr * n)

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
    rate = best_rate(est, batches[:ZOO_RATE_UPDATES], gen, BATCH)
    log(f"{ZOO_PATHS[0]}: {rate:.2f} update img/s (f32 B={BATCH} MC=1 "
        f"{SIZE}x{SIZE}, best of 3 blocks of {ZOO_RATE_UPDATES} updates; "
        f"{smi})")
    if profile:
        log(f"{ZOO_PATHS[0]} (one update):")
        profile_update(est, batches[0], gen)
    damping = ZOO_DAMPING["densenet121"]
    ensemble, invert_s = laplace_tail(est, model, test_data, gen, counters,
                                      "densenet121 kfac", damping)
    log(f"densenet121_kfac_invert: {invert_s:.4f} s (add={damping[0]}, "
        f"multiply={damping[1]}; {smi})")
    counters.reset()
    bnn_img_s = eval_rate(model, est, test_data[:ZOO_EVAL_BATCHES],
                          ensemble)
    if counters.read() != counters.want(none):
        raise AssertionError(f"densenet121 eval launched {counters.read()}")
    log(f"densenet121_bnn30_eval_img_s: {bnn_img_s:.2f} (best of 3 blocks "
        f"of {ZOO_EVAL_BATCHES * BATCH} images x {SAMPLES} samples; {smi})")
    del est, ensemble
    sub = estimators.KFAC(model, compute_dtype=torch.bfloat16,
                          token_subsample=0.25)
    by_path[ZOO_PATHS[1]] = drive_updates(sub, batches, gen, counters,
                                          ZOO_PATHS[1], none)
    rate = best_rate(sub, batches[:ZOO_RATE_UPDATES], gen, BATCH)
    log(f"{ZOO_PATHS[1]}: {rate:.2f} update img/s (bf16, "
        f"token_subsample=0.25, B={BATCH} MC=1, best of 3 blocks of "
        f"{ZOO_RATE_UPDATES} updates; {smi})")
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
        if counters.read() != counters.want(none):
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
    if counters.read() != counters.want(none):
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
                patch_gram_v2=routes[1] * ZOO_CLI_UPDATES,
                corr_gram=2 * routes[2] * ZOO_CLI_UPDATES)
    if got != counters.want(want, got) \
            or est.num_updates != ZOO_CLI_UPDATES:
        raise AssertionError(f"{ZOO_CLI_PATH}: launches {got}, want {want};"
                             f" {est.num_updates} updates")
    launches = got
    check_finite(est.state, f"{ZOO_CLI_PATH} state")
    for name, p in est.model.state_dict().items():
        if not torch.equal(p.cpu(), seeded.state_dict()[name]):
            raise AssertionError(f"the .pth did not load: {name}")
    x = next(common.on_device(common.build_data(parse_args(base), "train"),
                              est.device))[0]
    kernel_route_check(est, {}, x, routes, "densenet121 cifar10 B=32")
    argv = base + ["--estimator", "kfac", "--ood"] + R18_DAMPING \
        + OOD_CLI_SAMPLES
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
    if got != counters.want(none, got) or not np.isfinite(auroc).all():
        raise AssertionError(f"densenet121 evaluate: launches {got}, AUROC "
                             f"{auroc}")
    log(f"densenet121 cifar10 --ood svhn (random weights): NN accuracy "
        f"{100 * np.mean(probs.argmax(1) == labels):.2f}%, BNN "
        f"{100 * np.mean(bnn_probs.argmax(1) == labels):.2f}%; AUROC NN "
        f"{auroc[0]:.4f} BNN {auroc[1]:.4f}")
    return launches


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
        if counters.read() != counters.want(none):
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
                  patch_gram_v2=MAXVIT_ROUTES[1] * UPDATES,
                  corr_gram=2 * MAXVIT_ROUTES[2] * UPDATES)}

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
    if counters.read() != counters.want(none):
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
    if got != counters.want(none, got) \
            or tuple(est.state[name]["g"].shape) != (3, 768, 768) \
            or len(est.metas) != 5:
        raise AssertionError(f"vit_b_16 factors: launches {got}, "
                             f"{sorted(est.metas)}")
    check_finite(est.state, "vit_b_16 factors state")
    argv = vit + ["--estimator", "kfac", "--ood"] + R18_DAMPING \
        + OOD_CLI_SAMPLES
    (probs, bnn_probs, labels), got = run_cli(
        evaluate, argv, counters, smi, "vit_b_16 synthetic evaluate --ood")
    with np.load(results_paths(parse_args(argv))[0] + ".npz",
                 allow_pickle=True) as f:
        auroc = f["auroc"]
    for what, p in (("nn", probs), ("bnn", bnn_probs)):
        if p.shape != (256, 10) or not np.isfinite(p).all() \
                or np.abs(p.sum(1) - 1).max() > 1e-3:
            raise AssertionError(f"vit_b_16 {what} predictions malformed")
    if got != counters.want(none, got) or not np.isfinite(auroc).all():
        raise AssertionError(f"vit_b_16 evaluate: launches {got}, AUROC "
                             f"{auroc}")
    log(f"vit_b_16 synthetic --ood (random weights): NN accuracy "
        f"{100 * np.mean(probs.argmax(1) == labels):.2f}%, BNN "
        f"{100 * np.mean(bnn_probs.argmax(1) == labels):.2f}%; AUROC NN "
        f"{auroc[0]:.4f} BNN {auroc[1]:.4f}")
    est, got = run_cli(factors, SWIN_ARGV + base + ["--estimator", "kfac"],
                       counters, smi, "swin_t synthetic factors kfac")
    if got != counters.want(none, got):
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
        if got != counters.want(want or none, got):
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
        res, seconds = timed(lambda: cli(
            loss_landscape, base + [flag, "--plot"],
            f"lenet5 loss_landscape {flag} --plot"))
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
    if counters.read() != counters.want(none) \
            or not np.isfinite(res["train_loss"]).all():
        raise AssertionError(f"resnet18 loss1d: launches {counters.read()}")
    points = 2 * LANDSCAPE_R18_POINTS
    log(f"resnet18 loss1d at full width: {points} points (train, 512 "
        f"images, and val, 256) in {seconds:.3f} s, {seconds / points:.4f} "
        f"s per point ({smi})")
    log(f"training phase: {time.perf_counter() - t_phase:.1f} s ({smi})")
    return by_path


def subspace_phase(estimators, models, counters, smi, dev, profile=False):
    """The exact curvature on ResNet-18 CIFAR at full width (JAX
    ops/matfree.py, eval/fidelity.py, estimators/subspace.py,
    eval/influence.py; 10 classes, 32², seeded weights, B=128, f32, TF32
    off): (a) the rows of JAX's ``subspace_swag_pipeline``
    (benchmarks/suite.py:509-561): a rank-32 ``Subspace`` update after a
    warm one, best of 3 (``resnet18_subspace_update_rank32_b128``), a warm
    invert then one timed (``resnet18_subspace_invert``), a 30-sample
    ensemble after a warm one (``resnet18_subspace_sample30``), SWAG at
    rank 20 (``resnet18_swag_collect_b128``, ``resnet18_swag_sample30``);
    (b) checks that need no dense matrix: two sketch columns against
    ``ggn_matvec`` of their omega columns, ``quadratic_form(solve(d))``
    against ``<d, solve(d)>``, the top Ritz value of SUB_LANCZOS Lanczos
    steps at least the Rayleigh quotient of its injected start vector, and
    every BatchNorm running statistic unchanged by the phase; (c) the
    CLIs under SUB_ROOT: ``factors --estimator kfac --fidelity 4
    --spectrum 16`` (its KFAC fit launching R18_ROUTES' kernels an
    update, the npz files written), ``factors --estimator subspace --rank
    32``, ``evaluate --estimator subspace --ood`` and a 3-candidate
    ``hyper --estimator subspace``; (d) ``self_influence`` of
    SUB_INFLUENCE training examples under a KFAC fitted on 4 batches of
    32, its first score against ``precision_solve`` of that example's
    gradient. Returns the paths' launches."""
    import os
    import numpy as np
    import torch
    from curvature_tpu_torch.eval.influence import (
        per_example_grad_matrix, self_influence)
    from curvature_tpu_torch.ops import matfree
    from curvature_tpu_torch.pipelines import evaluate, factors, hyper
    from curvature_tpu_torch.utils.checkpoint import (
        factors_path, results_paths)
    from curvature_tpu_torch.utils.config import parse_args
    none = counters.zero()
    by_path = {}
    model = models.resnet18(num_classes=10, stem="cifar", device=dev)
    models.load_jax_variables(model, models.seeded_variables(model, 0))
    model = model.to(memory_format=torch.channels_last)
    rng = np.random.default_rng(51)
    (x, y), = nchw_batches(rng, 1, SUB_BATCH, dev, size=32)
    y = torch.as_tensor(y % 10, device=dev)
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    gen = torch.Generator(device=dev).manual_seed(52)

    # (a) the suite's rows
    torch.cuda.reset_peak_memory_stats()
    sub = estimators.Subspace(model, rank=SUB_RANK, omega_seed=0,
                              chunk=SUB_CHUNK)
    p = matfree.num_params(sub.metas)
    route = (f"vmapped columns, {SUB_CHUNK or sub.rank} a vmap")
    counters.reset()
    _, warm = timed(lambda: sub.update(x))
    times = [timed(lambda: sub.update(x))[1] for _ in range(3)]
    got = counters.read()
    by_path[SUB_PATHS[0]] = got
    if got != counters.want(none, got):
        raise AssertionError(f"{SUB_PATHS[0]}: launches {got}, want none")
    check_finite(sub.state, "subspace state")
    log(f"{SUB_PATHS[0]}: {1 / min(times):.4f} it/s (B={SUB_BATCH}, rank "
        f"{sub.rank}, p = {p:,} tracked parameters, {route}; best of 3 "
        f"after a warm update of {warm:.3f} s; updates "
        f"{', '.join(f'{t:.4f}' for t in times)} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{json.dumps(got)}; {smi})")
    sub.invert(1.0, 1e3)                                   # warm
    _, seconds = timed(lambda: sub.invert(2.0, 1e4))
    log(f"resnet18_subspace_invert: {seconds:.4f} s ({smi})")
    sub.ensemble_params(30, generator=gen)                 # warm
    ens, seconds = timed(lambda: sub.ensemble_params(30, generator=gen))
    for member in ens:
        check_finite(member, "subspace sample")
    del ens
    log(f"resnet18_subspace_sample30: {seconds:.4f} s ({smi})")
    swag = estimators.SWAG(model, max_rank=SUB_SWAG_RANK)
    params = {k: v.detach() for k, v in model.named_parameters()}
    swag.collect(params)                                   # warm
    _, seconds = timed(lambda: [swag.collect(
        {k: v * (1.0 + 1e-4 * i) for k, v in params.items()})
        for i in range(3)])
    log(f"resnet18_swag_collect_b{SUB_BATCH}: {3 / seconds:.4f} it/s "
        f"(3 collects after a warm one; {smi})")
    swag.finalize()
    swag.invert()
    swag.ensemble_params(30, generator=gen)                # warm
    ens, seconds = timed(lambda: swag.ensemble_params(30,
                                                          generator=gen))
    for member in ens:
        check_finite(member, "swag sample")
    del ens, swag
    log(f"resnet18_swag_sample30: {seconds:.4f} s ({smi})")
    if profile:
        log(f"{SUB_PATHS[0]} (B={SUB_BATCH}, rank {sub.rank}):")
        profile_fn(lambda: sub.update(x), "subspace update")

    # (b) checks without a dense matrix. 4 + profile updates of one batch:
    # the sketch is that many times F @ Omega
    updates = 4 + (2 if profile else 0)
    for r in (0, sub.rank - 1):
        col = {n: sub.state[n]["sketch"][r] / updates for n in sub.metas}
        want = matfree.ggn_matvec(model, sub.metas, x, {
            n: sub.state[n]["omega"][r] for n in sub.metas})
        err = max(float((col[n] - want[n]).abs().max()) for n in want) \
            / max(float(want[n].abs().max()) for n in want)
        log(f"subspace sketch column {r} against ggn_matvec of its omega "
            f"column: {err:.3e} of max (bar {SUB_RTOL})")
        if not err <= SUB_RTOL:
            raise AssertionError(f"sketch column {r}: {err:.3e} of max")
    d = matfree.random_deltas(sub.metas, gen, kind="normal")
    solved = sub.precision_solve(d, *SUB_DAMPING)
    inner = float(sum((d[n] * solved[n]).sum() for n in sub.metas))
    quad = sub.quadratic_form(solved, *SUB_DAMPING)
    err = abs(quad - inner) / abs(inner)
    log(f"subspace quadratic_form(solve(d)) {quad:.6e} against <d, solve(d)>"
        f" {inner:.6e}: {err:.3e} relative (bar {SUB_RTOL})")
    if not (err <= SUB_RTOL and inner > 0):
        raise AssertionError(f"subspace solve/quad: {quad} vs {inner}")
    del solved, d
    zeros = {n: torch.zeros(s, device=dev)
             for n, s in matfree.delta_shapes(sub.metas).items()}

    def matvec(v):
        return matfree.ggn_matvec(model, sub.metas, x, v)
    q0 = torch.randn(p, generator=gen, device=dev)
    (ritz, weights), seconds = timed(lambda: matfree.lanczos_topk(
        matvec, zeros, SUB_LANCZOS, q0=q0))
    q = q0 / torch.linalg.vector_norm(q0)
    rayleigh = float(q @ matfree._flatten(matvec(matfree._unflatten(
        q, zeros))))
    log(f"lanczos ({SUB_LANCZOS} steps, {seconds:.3f} s): top Ritz values "
        f"{', '.join(f'{v:.6g}' for v in ritz[:4].tolist())}; weights sum "
        f"{float(weights.sum()):.6f}; Rayleigh quotient of q0 "
        f"{rayleigh:.6g}")
    if not (float(ritz[0]) >= rayleigh * (1 - 1e-5)
            and torch.isfinite(ritz).all()):
        raise AssertionError(f"lanczos: top Ritz {float(ritz[0])} below the "
                             f"start vector's Rayleigh quotient {rayleigh}")
    del sub, q0, q, zeros
    torch.cuda.empty_cache()

    # (c) the CLIs
    root = os.path.abspath(SUB_ROOT)
    base = R18_ARGV + ["--root_dir", root, "--results_dir", root]
    argv = base + ["--estimator", "kfac"] + SUB_FIDELITY
    est, got = run_cli(factors, argv, counters, smi,
                       "resnet18 factors kfac --fidelity 4 --spectrum 16")
    want = dict(none, **{f"patch_gram_{r}": n * R18_UPDATES
                         for r, n in R18_ROUTES[R18_PATHS[0]].items()})
    if got != counters.want(want, got) or est.num_updates != R18_UPDATES:
        raise AssertionError(f"{SUB_PATHS[1]}: launches {got}, want {want}")
    by_path[SUB_PATHS[1]] = got
    stem = factors_path(parse_args(argv))
    with np.load(stem + "_fidelity.npz") as f:
        rows = {k.split("/")[0] for k in f.files}
        joint = {k.split("/")[1]: float(f[k]) for k in f.files
                 if k.startswith("__joint__/")}
        if rows != set(est.metas) | {"__joint__"} or not all(
                np.isfinite(f[k]).all() for k in f.files):
            raise AssertionError(f"fidelity file rows {sorted(rows)}")
    with np.load(stem + "_spectrum.npz") as f:
        ritz = f["ritz"]
        if ritz.shape != (16,) or not np.isfinite(ritz).all() \
                or (np.diff(ritz) > 0).any():
            raise AssertionError(f"spectrum file: ritz {ritz}")
    log(f"{SUB_PATHS[1]}: launches {json.dumps(got)} (R18_ROUTES x "
        f"{R18_UPDATES} updates); joint row {json.dumps(joint)}; top Ritz "
        f"{ritz[:3].tolist()}")
    del est
    argv = base + ["--estimator", "subspace", "--rank", str(SUB_RANK)]
    est, got = run_cli(factors, argv, counters, smi,
                       f"resnet18 factors subspace --rank {SUB_RANK}")
    if got != counters.want(none, got) or est.rank != SUB_RANK:
        raise AssertionError(f"subspace factors: launches {got}, rank "
                             f"{est.rank}")
    check_finite(est.state, "subspace CLI state")
    del est
    damping = ["--norm", str(SUB_DAMPING[0]), "--scale", str(SUB_DAMPING[1])]
    (probs, bnn_probs, labels), got = run_cli(
        evaluate, argv + ["--ood"] + damping, counters, smi,
        "resnet18 evaluate subspace --ood")
    with np.load(results_paths(parse_args(argv))[0] + ".npz",
                 allow_pickle=True) as f:
        auroc = f["auroc"]
    if got != counters.want(none, got) or bnn_probs.shape != (256, 10) \
            or not np.isfinite(bnn_probs).all() \
            or np.abs(bnn_probs.sum(1) - 1).max() > 1e-3 \
            or not np.isfinite(auroc).all():
        raise AssertionError(f"subspace evaluate: launches {got}, AUROC "
                             f"{auroc}")
    log(f"resnet18 subspace --ood (random weights): NN accuracy "
        f"{100 * np.mean(probs.argmax(1) == labels):.2f}%, BNN "
        f"{100 * np.mean(bnn_probs.argmax(1) == labels):.2f}%; AUROC NN "
        f"{auroc[0]:.4f} BNN {auroc[1]:.4f}")
    hyper_run(hyper, argv + SUB_HYPER, counters, smi,
              "resnet18 hyper subspace (random, 3 candidates)")

    # (d) self-influence under KFAC
    kfac = estimators.KFAC(model)
    counters.reset()
    quarter = SUB_BATCH // 4
    for i in range(4):
        kfac.update(x[quarter * i:quarter * (i + 1)], generator=gen)
    scores, seconds = timed(lambda: self_influence(
        kfac, x[:SUB_INFLUENCE], y[:SUB_INFLUENCE], *SUB_DAMPING))
    got = counters.read()
    want = dict(none, **{f"patch_gram_{r}": 4 * n
                         for r, n in R18_ROUTES[R18_PATHS[0]].items()})
    by_path[SUB_PATHS[2]] = got
    if got != counters.want(want, got):
        raise AssertionError(f"{SUB_PATHS[2]}: launches {got}, want {want}")
    # example 0's gradient from the same vmapped pass through
    # precision_solve: the vmapped solve_state against the direct one
    # (batch-statistics BatchNorm on one image is ill-conditioned, so a
    # pass at another vmap width differs by f32 rounding near the bar)
    g0 = {n: g[0] for n, g in per_example_grad_matrix(
        model, kfac.metas, x[:SUB_INFLUENCE], y[:SUB_INFLUENCE]).items()}
    s0 = float(sum((g0[n] * u).sum() for n, u in kfac.precision_solve(
        g0, *SUB_DAMPING).items()))
    del g0
    err = abs(float(scores[0]) - s0) / abs(s0)
    log(f"self_influence of {SUB_INFLUENCE} examples under KFAC: "
        f"{seconds:.3f} s; scores {float(scores.min()):.6g}.."
        f"{float(scores.max()):.6g}; example 0 against its own solve "
        f"{err:.3e} relative (bar {SUB_RTOL}); launches {json.dumps(got)} "
        f"({smi})")
    if not (torch.isfinite(scores).all() and (scores > 0).all()
            and err <= SUB_RTOL):
        raise AssertionError(f"self_influence: {scores[:4]}, {err}")
    for k, v in model.state_dict().items():
        if "running" in k and not torch.equal(v, stats0[k]):
            raise AssertionError(f"{k} moved during the subspace phase")
    log(f"subspace phase: every BatchNorm running statistic unchanged; peak "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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
    if counters.read() != counters.want():
        raise AssertionError(f"{label}: eval launched {counters.read()}")
    log(f"{label}: invert{LM_DAMPING} {inv_s:.3f} s; sample {sample_s:.3f} "
        f"s; {samples}-sample per-token bnn eval of {x.numel()} tokens "
        f"{eval_s:.3f} s: {json.dumps(token_stats(stats, label))} (random "
        "weights)")


def lm_updates(est, batches, gen, counters, label, sym=None):
    """``update`` over ``batches`` with the counters set to 0 just before
    and read just after: no patch or correlation Gram kernel may launch,
    the batched symmetric kernel ``sym`` times an update where given (else
    as the factor spans say)."""
    counters.reset()
    _, seconds = timed(lambda: [est.update(x, generator=gen)
                                for x, _ in batches])
    got = counters.read()
    log(f"{label}: {len(batches)} updates in {seconds:.3f} s; launches "
        f"{json.dumps(got)}")
    want = counters.zero()
    if sym is not None:
        want["sym_gram_batched"] = sym * len(batches)
    if got != counters.want(want, got):
        raise AssertionError(f"{label}: Gram kernels launched: {got}")
    check_finite(est.state, f"{label} state")
    return got


def lm_phase(estimators, models, counters, smi, dev, profile=False):
    """The causal-LM path on GPT-2 124M (seeded N(0, 0.02) weights in
    JAX's layout, carried across by ``models.load_jax_variables``): (a)
    KFAC over the stacked blocks at B=8, T=512 -- the rate, invert,
    sample, a 30-sample per-token eval, and depth slices against the
    unrolled model; (b) last-layer KFAC on the 50,257-word head with
    blocked G; (c) Diagonal, KFAC, EFB and INF over 4 batches, Block on
    gpt2_tiny's stacked ``h.attn.c_proj``; (d) the ``--data tokens`` CLIs.
    Returns (the rate, the launches of the update paths by path)."""
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
    by_path = {f"{LM_PATH}_warm": lm_updates(
        est, batches[:1], gen, counters, f"{LM_PATH} (warm update)",
        LM_SYM)}
    best = float("inf")
    for _ in range(3):
        counters.reset()
        _, seconds = timed(lambda: [est.update(x, generator=gen)
                                    for x, _ in batches[1:]])
        got = counters.read()
        if got != dict(none, sym_gram_batched=LM_SYM * LM_UPDATES):
            raise AssertionError(f"{LM_PATH}: launches {got}")
        by_path[LM_PATH] = got
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
    if counters.read() != counters.want(none):
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
    by_path["gpt2_ladder_diagonal"] = lm_updates(
        diag, ladder_batches, gen, counters, "gpt2 ladder diagonal", 0)
    lm_tail(diag, model, x, y, gen, counters, "gpt2 ladder diagonal",
            LM_LADDER_SAMPLES)
    kfac = estimators.KFAC(model, loss="lm", layer_filter="h.*")
    by_path["gpt2_ladder_kfac"] = lm_updates(
        kfac, ladder_batches, gen, counters, "gpt2 ladder kfac", LM_SYM)
    lm_tail(kfac, model, x, y, gen, counters, "gpt2 ladder kfac",
            LM_LADDER_SAMPLES)
    efb, eig_s = timed(lambda: estimators.EFB(model, kfac.state, loss="lm",
                                              layer_filter="h.*"))
    shapes = sorted({tuple(f[k].shape) for f in kfac.state.values()
                     for k in "ag"})
    log(f"gpt2 ladder efb: eigendecomposition of {2 * len(efb.metas)} "
        f"stacked factors ({shapes}) in {eig_s:.3f} s")
    by_path["gpt2_ladder_efb"] = lm_updates(
        efb, ladder_batches, gen, counters, "gpt2 ladder efb")
    lm_tail(efb, model, x, y, gen, counters, "gpt2 ladder efb",
            LM_LADDER_SAMPLES)
    counters.reset()
    inf = estimators.INF(model, efb.diags, kfac.state, efb.state,
                         eigvecs=efb.eigvecs, layer_filter="h.*")
    _, build_s = timed(lambda: inf.update(
        rank=INF_RANK, max_product=LM_INF_MAX_PRODUCT, bucket=INF_BUCKET))
    if counters.read() != counters.want(none):
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
    by_path["gpt2_tiny_ladder_block"] = lm_updates(
        blk, tb, gen, counters,
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
        if got != counters.want(none, got):
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
        if got != counters.want(none, got) or not np.isfinite(auroc).all():
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
    if got != counters.want(none, got) \
            or got2 != counters.want(none, got2) \
            or nn_s.shape != (n_tok, 4) or bnn_s.shape != (n_tok, 4):
        raise AssertionError(f"gpt2_tiny vocab: {got}, {got2}, "
                             f"{nn_s.shape}, {bnn_s.shape}")
    log(f"gpt2_tiny vocab 50257 per-token stats: NN "
        f"{json.dumps(token_stats(nn_s, 'nn'))}, BNN "
        f"{json.dumps(token_stats(bnn_s, 'bnn'))}")
    return rate, by_path


def option_timings(estimators, model, batches, gen, counters, expect,
                   label, smi, **kw):
    """KFAC with each of ``MOE_OPTIONS`` against the default on ``model``:
    one update on ``batches[0]``'s labels each, whose launches must equal
    ``expect`` and whose factors the default's within MOE_OPTION_RTOL of
    max; then the best of 3 single updates each, its ms printed. Returns
    {option: ms}."""
    x, y = batches[0]
    want, out = None, {}
    for opts in ({},) + MOE_OPTIONS:
        est = estimators.KFAC(model, **kw, **opts)
        counters.reset()
        est.update(x, labels=y)
        got = counters.read()
        if got != counters.want(expect, got):
            raise AssertionError(f"{label} {opts}: launches {got}, want "
                                 f"{expect}")
        if want is None:
            want = {n: {k: v.clone() for k, v in f.items()}
                    for n, f in est.state.items()}
        worst = max(rel_err(est.state[n][k], want[n][k])
                    for n in want for k in want[n])
        best = float("inf")
        for _ in range(3):
            _, seconds = timed(lambda: est.update(x, generator=gen))
            best = min(best, seconds)
        name = "+".join(opts) or "default"
        out[name] = 1e3 * best
        log(f"{label} kfac {name}: {out[name]:.1f} ms per update (best of 3"
            f" after one); factors vs the default {worst:.3e} of max (bar "
            f"{MOE_OPTION_RTOL}); {len(est.gram_probe_names)} layers fused; "
            f"launches {json.dumps(got)} ({smi})")
        if worst > MOE_OPTION_RTOL:
            raise AssertionError(f"{label} {opts}: factors {worst:.3e} off")
        del est
    return out


def prepare_moe_model(models):
    """The MoE phase's Switch GPT-2 at full width with its seeded weights,
    built on the CPU in a thread (the numpy draws and torch's copies
    release the GIL), so that it overlaps the kernels' build; returns the
    thread's future, whose model :func:`moe_phase` moves to the card."""
    from concurrent.futures import ThreadPoolExecutor

    def build():
        t0 = time.perf_counter()
        model = models.gpt2_moe_custom(LM_VOCAB, *MOE_WIDTH, MOE_EXPERTS,
                                       max_len=LM_T, device="cpu")
        models.load_jax_variables(model, models.seeded_variables(model, 0))
        return model, time.perf_counter() - t0
    pool = ThreadPoolExecutor(1)
    future = pool.submit(build)
    pool.shutdown(wait=False)
    return future


def moe_phase(estimators, models, counters, smi, dev, profile=False,
              prepared=None):
    """The mixture-of-experts path: (a) the Switch GPT-2 at GPT-2 124M's
    width, E=8, through KFAC over the blocks (the rate, the state, the
    peak, invert at LM_DAMPING, a sample, a per-token eval; each expert's
    routed share at ``h.0`` and its A factor against float64); (b) JAX
    suite's MoE row; (c) ``stack_grams`` and ``fused_g`` against the
    default on the unrolled GPT-2 124M and on ResNet-50; (d) the
    ``gpt2_moe_tiny --data tokens`` CLIs; (e) the ``moe_laplace``
    example. Returns the rate."""
    import os
    import numpy as np
    import torch
    from curvature_tpu_torch.examples import moe_laplace
    from curvature_tpu_torch.pipelines import evaluate, factors
    from curvature_tpu_torch.utils.checkpoint import factors_path, load_pytree
    from curvature_tpu_torch.utils.config import parse_args
    none = counters.zero()
    rng = np.random.default_rng(21)
    gen = torch.Generator(device=dev).manual_seed(22)

    # (a) the main path at full width
    t0 = time.perf_counter()
    if prepared is None:
        prepared = prepare_moe_model(models)
    model, cpu_s = prepared.result()
    model = model.to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{MOE_PATH}: model of {n_params:,} parameters with seeded weights "
        f"built on the CPU in {cpu_s:.1f} s (with the kernels' build in a "
        f"whole run), on the card {time.perf_counter() - t0:.1f} s later")
    batches = lm_tokens(rng, 1 + MOE_UPDATES, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    est = estimators.KFAC(model, loss="lm", layer_filter="h.*")
    lm_updates(est, batches[:1], gen, counters, f"{MOE_PATH} (warm update)")
    best = float("inf")
    for _ in range(3):
        counters.reset()
        _, seconds = timed(lambda: [est.update(x, generator=gen)
                                    for x, _ in batches[1:]])
        if counters.read() != counters.want(none):
            raise AssertionError(f"{MOE_PATH}: launches {counters.read()}")
        best = min(best, seconds)
    rate = LM_BATCH * LM_T * MOE_UPDATES / best
    check_finite(est.state, f"{MOE_PATH} state")
    log(f"{MOE_PATH}: {rate:.2f} tokens/s (Switch GPT-2 at 124M width, E="
        f"{MOE_EXPERTS}, unrolled, f32, B={LM_BATCH} T={LM_T} MC=1, layers "
        f"h.*, best of 3 blocks of {MOE_UPDATES} updates: "
        f"{1e3 * best / MOE_UPDATES:.1f} ms per update; {smi})")
    state_gb = sum(t.numel() * t.element_size() for f in est.state.values()
                   for t in f.values()) / 1e9
    blocks = sum(m.stacked for m in est.metas.values() if m.moe)
    log(f"{MOE_PATH}: KFAC state {state_gb:.3f} GB ({blocks} per-expert "
        f"factor blocks); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
    if profile:
        log(f"{MOE_PATH} (one update):")
        profile_update(est, batches[0][0], gen)
    x, y = batches[0]
    lm_tail(est, model, x, y, gen, counters, "gpt2 moe 124m kfac",
            MOE_SAMPLES)
    del est
    torch.cuda.empty_cache()
    # routed shares and an expert A factor from one capture
    chk = estimators.KFAC(model, loss="lm", layer_filter=MOE_CHECKED)
    cap = chk.capture(x, labels=y)
    chk._accumulate(cap)
    # KFAC's capture keeps the routed rows: the masked stream rebuilt
    xm = cap.routes[MOE_CHECKED].dense(
        cap.acts[MOE_CHECKED]).double()                   # [E, B, T, F]
    t = xm.reshape(xm.shape[0], -1, xm.shape[-1])
    routed = (t != 0).any(-1)                              # [E, N]
    shares = routed.double().mean(-1).tolist()
    log(f"h.0 routed shares by expert (top-1, {t.shape[1]} tokens): "
        f"{json.dumps([round(v, 4) for v in shares])}, sum "
        f"{sum(shares):.6f}")
    if not bool((routed.sum(0) == 1).all()):
        raise AssertionError("a token routed to other than one expert")
    want = t.mT @ t / t.shape[1]
    err = rel_err(chk.state[MOE_CHECKED]["a"].double(), want)
    log(f"{MOE_CHECKED} A factor vs sum over routed a_n a_n^T / N in float64:"
        f" {err:.3e} of max (bar {MOE_RTOL})")
    if err > MOE_RTOL:
        raise AssertionError(f"{MOE_CHECKED} A factor {err:.3e} off")
    del chk, cap, xm, t, want, model
    torch.cuda.empty_cache()

    # (b) JAX suite's MoE row
    small = models.gpt2_moe_custom(**MOE_SUITE, device=dev)
    models.load_jax_variables(small, models.seeded_variables(small, 0))
    tok = torch.from_numpy(rng.integers(
        0, MOE_SUITE["vocab"], (MOE_SUITE_BATCH, MOE_SUITE["max_len"]))
    ).to(dev)
    est = estimators.KFAC(small, loss="lm", layer_filter="h.*")
    lm_updates(est, [(tok, None)], gen, counters, "gpt2_moe suite (warm)")
    best = float("inf")
    for _ in range(3):
        counters.reset()
        _, seconds = timed(lambda: [est.update(tok, generator=gen)
                                    for _ in range(MOE_SUITE_UPDATES)])
        if counters.read() != counters.want(none):
            raise AssertionError(f"gpt2_moe suite: {counters.read()}")
        best = min(best, seconds)
    suite_rate = tok.numel() * MOE_SUITE_UPDATES / best
    est.invert(2.0, 20000.0)
    _, inv_s = timed(lambda: est.invert(1.0, 18916.0))
    check_finite(est.sample(generator=gen), "gpt2_moe suite sample")
    blocks = sum(m.stacked for m in est.metas.values() if m.moe)
    log(f"gpt2_moe_kfac_update_tok_s: {suite_rate:.2f} (the suite's Switch "
        f"GPT-2, dim 256, depth 4, E=8, f32, B={MOE_SUITE_BATCH} T="
        f"{MOE_SUITE['max_len']}, best of 3 blocks of {MOE_SUITE_UPDATES}; "
        f"{smi})")
    log(f"gpt2_moe_kfac_invert_s: {inv_s:.4f} (invert(1, 18916) after a "
        f"warm invert(2, 20000); {smi})")
    log(f"gpt2_moe_expert_factor_blocks: {blocks} ({smi})")
    if blocks != MOE_SUITE_BLOCKS:
        raise AssertionError(f"{blocks} expert factor blocks, want "
                             f"{MOE_SUITE_BLOCKS}")
    del est, small

    # (c) stack_grams and fused_g against the default: the unrolled GPT-2
    # 124M (no kernel), ResNet-50 f32 (its tiled and v2 launches)
    gpt = models.gpt2(LM_VOCAB, max_len=LM_T, device=dev)
    models.load_jax_variables(gpt, models.seeded_variables(gpt, 0))
    gpt_ms = option_timings(estimators, gpt, batches, gen, counters, none,
                            "gpt2 124m unrolled", smi, loss="lm",
                            layer_filter="h.*")
    del gpt
    torch.cuda.empty_cache()
    r50 = models.resnet50(num_classes=CLASSES, device=dev)
    models.load_jax_variables(r50, models.seeded_variables(r50, 0))
    r50 = r50.to(memory_format=torch.channels_last)
    imgs = [(x, torch.arange(BATCH, device=dev))
            for x, _ in nchw_batches(rng, 1, BATCH, dev)]
    r50_ms = option_timings(estimators, r50, imgs, gen, counters,
                            dict(none, patch_gram_tiled=3, patch_gram_v2=1,
                                 corr_gram=R50_CORR),
                            "resnet50 f32 B=16", smi)
    log(f"kfac options, ms per update: gpt2 124m {json.dumps(gpt_ms)}; "
        f"resnet50 {json.dumps(r50_ms)} ({smi})")
    del r50, imgs
    torch.cuda.empty_cache()

    # (d) the --data tokens CLIs on gpt2_moe_tiny
    root = os.path.abspath(os.path.join(MOE_ROOT, "gpt2_moe_tiny"))
    base = MOE_ARGV + ["--root_dir", root, "--results_dir", root,
                       "--estimator", "kfac"]
    est, got = run_cli(factors, base, counters, smi,
                       "gpt2_moe_tiny tokens factors kfac")
    saved = load_pytree(factors_path(parse_args(base)))
    for name, meta in est.metas.items():
        lead = (meta.stacked,) if meta.stacked else ()
        want_shapes = {"a": lead + (meta.mat_cols,) * 2,
                       "g": lead + (meta.out_features,) * 2}
        have = {k: tuple(np.shape(v)) for k, v in saved[name].items()}
        if have != want_shapes or not all(np.isfinite(v).all()
                                          for v in saved[name].values()):
            raise AssertionError(f"factor file {name}: {have}")
    if sorted(saved) != sorted(est.metas) or got != counters.want(none, got):
        raise AssertionError(f"gpt2_moe_tiny factors: {sorted(saved)}, {got}")
    log(f"gpt2_moe_tiny factor file: {len(saved)} layers under JAX's keys, "
        f"per-expert {tuple(np.shape(saved['h.0.moe.fc1']['a']))} A")
    (probs, bnn_probs, labels), got = run_cli(
        evaluate, base + ["--ood"] + LM_CLI_DAMPING, counters, smi,
        "gpt2_moe_tiny tokens evaluate kfac --ood")
    for what, p in (("nn", probs), ("bnn", bnn_probs)):
        if p.shape != (256 * 16, 256) or not np.isfinite(p).all() \
                or np.abs(p.sum(1) - 1).max() > 1e-3:
            raise AssertionError(f"gpt2_moe_tiny {what} malformed")
    if got != counters.want(none, got):
        raise AssertionError(f"gpt2_moe_tiny evaluate launched {got}")
    log(f"gpt2_moe_tiny tokens kfac --ood (random weights): NN accuracy "
        f"{100 * np.mean(probs.argmax(1) == labels):.2f}%, BNN "
        f"{100 * np.mean(bnn_probs.argmax(1) == labels):.2f}% per token")

    # (e) the example on the card
    res, got = run_cli(moe_laplace, [], counters, smi, "examples.moe_laplace")
    if got != counters.want(none, got) or not np.isfinite(
            [res["map_nll"], res["bnn_nll"], res["log_marglik"]]).all():
        raise AssertionError(f"moe_laplace: {got}, {res}")
    return rate


def images_check(images, fixtures):
    """Every committed fixture decoded here against PIL's decode
    (``expected.npz``), 0 differing pixels; one line per format; then the
    JAX loader's committed batches from the port's loader. Returns the
    expected arrays."""
    import os
    import shutil
    import tempfile
    import numpy as np
    from curvature_tpu_torch.data import loaders
    expected = np.load(os.path.join(fixtures, "expected.npz"))
    counts, bad = {}, []
    for name in sorted(os.listdir(fixtures)):
        if name == "expected.npz":
            continue
        path = os.path.join(fixtures, name)
        with open(path, "rb") as f:
            kind = images.sniff(f.read(8))
        got, want = images.open_rgb(path), expected[name]
        diff = int((got != want).any(-1).sum()) if got.shape == want.shape \
            else -1
        counts.setdefault(kind, [0, 0])
        counts[kind][0] += 1
        if diff:
            counts[kind][1] += 1
            bad.append((name, got.shape, want.shape, diff))
    for kind, (n, wrong) in sorted(counts.items()):
        log(f"images: {n} {kind} fixtures decoded, {wrong} with a pixel "
            f"off PIL's decode (expected.npz)")
    if bad:
        raise AssertionError(f"decodes off PIL's: {bad}")
    tmp = tempfile.mkdtemp(prefix="img_batches_")
    try:
        for size in (224, 64):
            files = [str(f) for f in expected[f"files{size}"]]
            for rel in files:
                os.makedirs(os.path.join(tmp, str(size), os.path.dirname(rel)),
                            exist_ok=True)
                shutil.copyfile(os.path.join(fixtures, os.path.basename(rel)),
                                os.path.join(tmp, str(size), rel))
            loader = loaders.ImageFolderLoader(os.path.join(tmp, str(size)),
                                               size)
            x, y = loader.load_batch(range(len(files)))
            if not (x.dtype == np.float32
                    and np.array_equal(x, expected[f"batch{size}"])
                    and np.array_equal(y, expected[f"labels{size}"])):
                raise AssertionError(f"the {size}² batch is off JAX's loader")
            log(f"images: the {size}² batch of {len(files)} equals JAX's "
                "loader's (expected.npz), float32 bit for bit")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return expected


def image_tree(fixtures, root):
    """``root/imagenet/{train,val,art}`` and ``root/gtsrb/{train,val,test}``
    of fixture copies under new names (IMG_TRAIN, IMG_VAL, IMG_ART,
    IMG_GTSRB). Returns the ImageNet-shaped JPEGs' paths."""
    import os
    import shutil
    names = sorted(n for n in os.listdir(fixtures) if n != "expected.npz")
    big = [n for n in names if n.startswith("jpeg_420_q")]
    ppm = [n for n in names if n.endswith(".ppm")]

    def fill(d, picks, count, tag):
        os.makedirs(d, exist_ok=True)
        for i in range(count):
            src = picks[(i + len(tag)) % len(picks)]
            shutil.copyfile(os.path.join(fixtures, src), os.path.join(
                d, f"{tag}_{i:04d}{os.path.splitext(src)[1]}"))
    if os.path.exists(root):
        shutil.rmtree(root)
    im = os.path.join(root, "imagenet")
    classes, per = IMG_TRAIN
    for c in range(classes):
        fill(os.path.join(im, "train", f"n{c:08d}"), big, per, f"t{c}")
    fill(os.path.join(im, "val", "n00000000"), names, IMG_VAL // 2, "v0")
    fill(os.path.join(im, "val", "n00000001"), names[::-1], IMG_VAL // 2,
         "v1")
    classes, per = IMG_ART
    for c in range(classes):
        fill(os.path.join(im, "art", f"a{c}"), big + names, per, f"a{c}")
    for c, n in enumerate(IMG_GTSRB):
        fill(os.path.join(root, "gtsrb", "train", f"{c:05d}"), ppm, n,
             f"g{c}")
        for split in ("val", "test"):
            fill(os.path.join(root, "gtsrb", split, f"{c:05d}"), ppm, 2,
                 split)
    return [os.path.join(fixtures, n) for n in big]


def images_phase(counters, smi, update_img_s=None):
    """The image-folder loaders on the card's host and the CLIs that read
    them (ROADMAP Queue 1 item 9): the fixtures against PIL's decodes,
    the host rates (one thread's decode and load per ImageNet-shaped JPEG,
    ParallelDecodeLoader at IMG_WORKERS threads), ``factors`` of ResNet-50
    on the JPEG folder at full width (its launches asserted from JAX's
    routes, its kernel-routed A factors against the plain path), the
    ``evaluate --ood`` chain to the art folder, and ``factors --data
    gtsrb``. Returns the factors runs' launches by path."""
    import os
    import numpy as np
    import torch
    from curvature_tpu_torch import estimators
    from curvature_tpu_torch.data import images, loaders, prefetch
    from curvature_tpu_torch.pipelines import common, evaluate, factors
    from curvature_tpu_torch.utils.checkpoint import results_paths
    from curvature_tpu_torch.utils.config import parse_args
    t_phase = time.perf_counter()
    none = counters.zero()
    fixtures = loaders.IMAGE_FIXTURE_DIR
    images_check(images, fixtures)
    root = os.path.abspath(IMG_ROOT)
    big = image_tree(fixtures, root)
    cpus = os.cpu_count()

    # one thread: decode, and the loader's whole _load (decode, resize of
    # the shorter side to 256, crop 224), per ImageNet-shaped JPEG
    for fn, what in ((images.open_rgb, "decode"),
                     (lambda p: images.load_image(p, SIZE),
                      "decode+resize+crop")):
        for p in big:
            fn(p)
        reps, t0 = 5, time.perf_counter()
        for _ in range(reps):
            for p in big:
                fn(p)
        ms = (time.perf_counter() - t0) / (reps * len(big)) * 1e3
        log(f"images: {what} {ms:.3f} ms per 500x375/375x500/333x500 JPEG "
            f"on one thread ({len(big)} files x {reps}; host of {cpus} "
            f"CPUs; {smi})")
    data_dir = root
    train = loaders.imagenet(os.path.join(data_dir, "imagenet"), SIZE, BATCH)
    threaded = prefetch.ParallelDecodeLoader(train, workers=IMG_WORKERS)
    list(threaded)
    t0 = time.perf_counter()
    n = sum(len(y) for _, y in threaded)
    img_s = n / (time.perf_counter() - t0)
    log(f"images: ParallelDecodeLoader(workers={IMG_WORKERS}) {img_s:.2f} "
        f"img/s at {SIZE}² ({n} images, batches of {BATCH}; host of {cpus} "
        f"CPUs; {smi})")

    # factors on the JPEG folder: the CLI's loop timed inside it, and each
    # update call in it, so the rest is the loop's wait for batches
    base = IMG_ARGV + ["--data_dir", data_dir, "--root_dir", root,
                       "--results_dir", root]
    loop, calls = {}, []
    compute, update = factors.compute_factors, estimators.KFAC.update

    def timed_compute(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = compute(*a, **k)
        torch.cuda.synchronize()
        loop["s"] = time.perf_counter() - t
        return out

    def timed_update(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(self, *a, **k)
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t)
        return out
    factors.compute_factors, estimators.KFAC.update = (timed_compute,
                                                       timed_update)
    try:
        est, got = run_cli(factors, base, counters, smi,
                           "resnet50 imagenet-folder factors kfac")
    finally:
        factors.compute_factors, estimators.KFAC.update = compute, update
    n_train = IMG_TRAIN[0] * IMG_TRAIN[1]
    updates = n_train // BATCH
    want = dict(none, patch_gram_tiled=IMG_ROUTES[0] * updates,
                patch_gram_v2=IMG_ROUTES[1] * updates,
                corr_gram=2 * IMG_ROUTES[2] * updates)
    if got != counters.want(want, got) or est.num_updates != updates \
            or len(calls) != updates:
        raise AssertionError(f"{IMG_PATHS[0]}: launches {got}, want {want}; "
                             f"{est.num_updates} updates")
    folder = got
    check_finite(est.state, f"{IMG_PATHS[0]} state")
    wait = loop["s"] - sum(calls)
    steady = BATCH * (updates - 1) / sum(calls[1:])
    rate = f"; the synthetic-batch rate of this run {update_img_s:.2f}" \
        if update_img_s else ""
    log(f"images: factors CLI {n_train / loop['s']:.2f} img/s through its "
        f"loop ({n_train} images, {loop['s']:.3f} s; --scan_chunk 8, "
        f"DevicePrefetcher depth 2): {sum(calls):.3f} s in {updates} "
        f"update calls (first {calls[0]:.3f} s, the rest {steady:.2f} "
        f"img/s{rate}), {wait:.3f} s ({100 * wait / loop['s']:.1f}%) "
        f"waiting for the folder's batches ({smi})")
    x = next(common.on_device(common.build_data(parse_args(base), "train"),
                              est.device))[0]
    kernel_route_check(est, {}, x, IMG_ROUTES, "resnet50 imagenet folder "
                       f"B={BATCH}")
    del est
    torch.cuda.empty_cache()

    argv = base + ["--ood", "--plot", "--norm", str(ADD), "--scale",
                   str(MULTIPLY)] + OOD_CLI_SAMPLES
    (probs, bnn_probs, labels), got = run_cli(
        evaluate, argv, counters, smi, "resnet50 imagenet-folder evaluate "
        "--ood --plot art")
    with np.load(results_paths(parse_args(argv))[0] + ".npz",
                 allow_pickle=True) as f:
        auroc = f["auroc"]
    for what, p in (("nn", probs), ("bnn", bnn_probs)):
        if p.shape != (IMG_VAL, CLASSES) or not np.isfinite(p).all() \
                or np.abs(p.sum(1) - 1).max() > 1e-3:
            raise AssertionError(f"imagenet folder {what} predictions "
                                 "malformed")
    if got != counters.want(none, got) or not np.isfinite(auroc).all():
        raise AssertionError(f"imagenet folder evaluate: launches {got}, "
                             f"AUROC {auroc}")
    log(f"images: imagenet folder --ood art (random weights): AUROC NN "
        f"{auroc[0]:.4f} BNN {auroc[1]:.4f}")
    torch.cuda.empty_cache()

    gbase = GTSRB_ARGV + ["--data_dir", data_dir, "--root_dir", root,
                          "--results_dir", root]
    est, ggot = run_cli(factors, gbase, counters, smi,
                        "resnet18 gtsrb-folder factors kfac")
    train = loaders.gtsrb(os.path.join(data_dir, "gtsrb"), 32, 32,
                          splits="train")
    gupdates = len(train)
    routes = R18_ROUTES[R18_PATHS[0]]
    gwant = dict(none, patch_gram_tiled=routes["tiled"] * gupdates,
                 patch_gram_v2=routes["v2"] * gupdates)
    if ggot != counters.want(gwant, ggot) or est.num_updates != gupdates \
            or not train.class_balanced:
        raise AssertionError(f"{IMG_PATHS[1]}: launches {ggot}, want "
                             f"{gwant}; {est.num_updates} updates")
    check_finite(est.state, f"{IMG_PATHS[1]} state")
    del est
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"images phase: {seconds:.1f} s, "
        f"{'within' if seconds <= IMG_BUDGET_S else 'OVER'} its "
        f"{IMG_BUDGET_S:.0f} s budget ({smi})")
    return {IMG_PATHS[0]: folder, IMG_PATHS[1]: ggot}


def figures_phase(counters, smi):
    """The figures (JAX pipelines/plot.py and the figure half of
    visualize.py, ROADMAP Queue 1 item 7), drawn from what the earlier
    phases wrote: the --plot CLIs' files under JAX's names (ResNet-18's
    OOD panels from the factors whose f32 update launched
    ``R18_ROUTES``' kernels, ResNet-50's from the JPEG folder's, LeNet-5's
    FGSM sweep and random search, the training phase's landscapes), then
    ``visualize`` over the three roots with every figure toggle and
    ``--summary`` (no kernel launches). Each file must pass
    ``utils/pdf.read_pdf``, show its labels and paint at least its series
    or bars (``FIG_KINDS``). Prints the files, their bytes, the phase's
    seconds against ``FIG_BUDGET_S`` and the slowest figure's (from the
    previous figure's end, or its visualize call's start, to its file)."""
    import os
    from curvature_tpu_torch.data.loaders import FIXTURE_DIR
    from curvature_tpu_torch.pipelines import visualize
    from curvature_tpu_torch.utils import figure, pdf
    from curvature_tpu_torch.utils.checkpoint import results_paths
    from curvature_tpu_torch.utils.config import parse_args
    t_phase = time.perf_counter()
    none = counters.zero()

    def fig(argv, subdir=""):
        return results_paths(parse_args(argv), subdir)[1]

    def check(path):
        if not os.path.exists(path):
            raise AssertionError(f"figures: {path} was not written")
        info = pdf.read_pdf(path)
        suffix = max((s for s in FIG_KINDS if path.endswith(s)), key=len)
        want, least = FIG_KINDS[suffix]
        missing = [w for w in want if not any(
            s == w or (w.endswith(": ") and s.startswith(w))
            for s in info["strings"])]
        if info["pages"] != 1 or missing or info["painted"] < least:
            raise AssertionError(
                f"figures: {path}: {info['pages']} pages, missing {missing}"
                f", {info['painted']} paths painted (at least {least})")
        return info["bytes"]

    lenet = os.path.abspath(os.path.join(PIPE_ROOT, "lenet5"))
    r18 = os.path.abspath(os.path.join(PIPE_ROOT, "resnet18"))
    train = os.path.abspath(os.path.join(TRAIN_ROOT, "lenet5"))
    img = os.path.abspath(IMG_ROOT)
    lenet_argv = LENET_ARGV + ["--data_dir", FIXTURE_DIR, "--root_dir",
                               lenet, "--results_dir", lenet,
                               "--estimator", "kfac"]
    r18_argv = {e: R18_ARGV + ["--root_dir", r18, "--results_dir", r18,
                               "--estimator", e] for e in ("kfac", "efb")}
    train_argv = LENET_ARGV + ["--data_dir", FIXTURE_DIR, "--root_dir",
                               train, "--results_dir", train,
                               "--estimator", "kfac"]
    img_argv = IMG_ARGV + ["--data_dir", img, "--root_dir", img,
                           "--results_dir", img]
    # (a) what the --plot CLIs wrote
    plotted = [fig(r18_argv[e]) + s for e in r18_argv for s in FIG_OOD]
    plotted += [fig(lenet_argv) + "_fgsm.pdf",
                fig(lenet_argv + ["--results_dir", os.path.join(
                    lenet, "hyper")], "random") + "_hyper.pdf",
                fig(train_argv) + "_loss1d.pdf",
                fig(train_argv) + "_loss2d.pdf"]
    plotted += [fig(img_argv) + s for s in FIG_OOD]
    sizes = {p: check(p) for p in plotted}

    # (b) visualize over the roots, every figure toggle; each expected
    # file removed first, so that visualize is what writes it
    runs = (
        ("resnet18 pipeline root", r18_argv["kfac"] + [
            "--calibration", "--networks", "--ood", "--ecdf", "--entropy",
            "--eigvals", "--summary"],
         [fig(r18_argv["kfac"]) + s for s in (
             "_calibration.pdf", "_networks.pdf", *FIG_OOD,
             "_eigvals.pdf")]),
        ("lenet5 training root", train_argv + [
            "--optimizer", "random", "--eigvals", "--hyper", "--fgsm",
            "--landscapes", "--summary"],
         [fig(train_argv) + s for s in (
             "_eigvals.pdf", "_hyper.pdf", "_fgsm.pdf", "_loss1d.pdf",
             "_loss2d.pdf")]),
        ("resnet50 images root", img_argv + [
            "--calibration", "--ood", "--ecdf", "--entropy"],
         [fig(img_argv) + s for s in ("_calibration.pdf", *FIG_OOD)]))
    toggles = {f"--{t}" for t in visualize.FIGURE_TOGGLES} | {"--summary"}
    slowest, mark = (0.0, ""), [0.0]
    savefig = figure.Figure.savefig

    def timed_savefig(self, path, **kw):
        nonlocal slowest
        savefig(self, path, **kw)
        now = time.perf_counter()
        if now - mark[0] > slowest[0]:
            slowest = (now - mark[0], os.path.basename(path))
        mark[0] = now
    figure.Figure.savefig = timed_savefig
    try:
        for label, argv, expect in runs:
            for p in expect:
                if os.path.exists(p):
                    os.remove(p)
            mark[0] = time.perf_counter()
            flags = " ".join(a for a in argv if a in toggles)
            _, got = run_cli(visualize, argv, counters, smi,
                             f"visualize {label} {flags}")
            if got != counters.want(none, got):
                raise AssertionError(f"visualize {label} launched {got}")
            sizes.update({p: check(p) for p in expect})
    finally:
        figure.Figure.savefig = savefig
    seconds = time.perf_counter() - t_phase
    log(f"figures: {len(sizes)} files, {sum(sizes.values())} bytes, "
        f"{seconds:.1f} s, {'within' if seconds <= FIG_BUDGET_S else 'OVER'}"
        f" its {FIG_BUDGET_S:.0f} s budget; {len(plotted)} written by "
        f"--plot CLIs, {sum(len(e) for _, _, e in runs)} by visualize; "
        f"slowest figure {slowest[0]:.3f} s ({slowest[1]}) ({smi})")


def surface_phase(estimators, models, counters, smi, dev):
    """The JAX package's public surface on the card (ROADMAP Queue 1):
    (a) the tutorial (docs/tutorial.md §2-3 and §6) through the top-level
    names on LeNet-5 with its bundled weights and the digits: Diagonal,
    KFAC, EFB and INF(rank=100) updated and inverted at ``SURF_DAMPING``,
    each evaluated by ``eval.eval_bnn`` (30 samples, one vmapped forward a
    batch) with ``eval.accuracy`` and ``eval.expected_calibration_error``,
    then ``laplace.fit(subset="last")``, ``optimize_prior_precision()``
    and the linearized predictive, each step timed by a ``utils.Timer``;
    (b) ``utils.profile_trace`` of one ResNet-18 CIFAR f32 KFAC update
    (``R18_ARGV``'s model, B=32), whose trace must hold exactly the Gram
    launches its counters assert (``R18_ROUTES``: 8 tiled + 1 v2); (c) the
    ensemble's two routes (``evaluate.vmaps``) on each side of its pixel
    limit, each held to a member loop written here
    (``SURF_ENSEMBLE_TOL``) with its rate and peak memory: ResNet-50 at
    224² (f32, B=16, 30 members, TF32 off; the rule's member loop, vmap
    forced), ResNet-18 CIFAR at 32² (B=32; the rule's vmap, the loop
    forced); and the linearized predictive's rate on ResNet-18 beside the
    sampled one's; (d) every function of
    ``pipelines/plot.py`` written to PNG and SVG from (a)'s results: each
    PNG decoded by ``data/images.open_rgb`` at ``round(figsize x 300)``
    pixels with ink inside every axes and every string's box, each SVG
    parsed by ``xml.etree`` with the strings ``read_pdf`` finds in the
    same figure's PDF. Returns {path: launches}."""
    import os
    import tempfile
    import numpy as np
    import torch
    from torch.func import functional_call
    import curvature_tpu_torch as ct
    from curvature_tpu_torch import eval as E
    from curvature_tpu_torch import laplace
    from curvature_tpu_torch.data import images
    from curvature_tpu_torch.data.loaders import FIXTURE_DIR
    from curvature_tpu_torch.eval.evaluate import prepare_ensemble, vmaps
    from curvature_tpu_torch.pipelines import common, loss_landscape, plot
    from curvature_tpu_torch.utils import (
        Timer, figure, pdf, png, profile_trace, svg)
    from curvature_tpu_torch.utils.config import parse_args
    t_phase = time.perf_counter()
    none = counters.zero()
    timer = Timer()
    by_path = {}

    # (a) the tutorial through the public names
    cfg = parse_args(LENET_ARGV + ["--data_dir", FIXTURE_DIR])
    model = common.build_model(cfg)
    train_np = list(common.build_data(cfg, splits="train"))
    test_np = list(common.build_data(cfg, splits="test"))

    def on_card(batches):
        return [(common.nchw(common.device_batch(x, dev)), y)
                for x, y in batches]
    train, test = on_card(train_np), on_card(test_np)
    sync_on = test[0][0]
    gen = torch.Generator(device=dev).manual_seed(0)
    counters.reset()
    fitted, results = {}, {}
    for name in ("Diagonal", "KFAC", "EFB", "INF"):
        # block_on: a tensor on the card, whose device the Timer syncs
        with timer.phase(f"{name} update", block_on=sync_on):
            if name == "EFB":
                est = ct.EFB(model, fitted["KFAC"].state)
            elif name == "INF":
                efb = fitted["EFB"]
                est = ct.INF(model, efb.diags, fitted["KFAC"].state,
                             efb.state, eigvecs=efb.eigvecs)
                est.update(rank=SURF_INF_RANK)
            else:
                est = getattr(ct, name)(model)
            if name != "INF":
                for x, _ in train:
                    est.update(x, generator=gen, num_samples=SURF_MC)
        with timer.phase(f"{name} invert", block_on=sync_on):
            est.invert(*SURF_DAMPING[name])
        check_finite(est.inv_state, f"surface {name} inv_state")
        with timer.phase(f"{name} eval_bnn"):
            probs, labels, stats = E.eval_bnn(
                model, est, test, samples=SURF_SAMPLES, generator=gen,
                stats=True)
        if not np.isfinite(probs).all():
            raise AssertionError(f"surface {name}: non-finite predictions")
        fitted[name] = est
        results[name] = (probs, labels, stats)
        log(f"surface tutorial {name}: accuracy "
            f"{float(E.accuracy(probs, labels)):.2f}%, ECE "
            f"{100 * float(E.expected_calibration_error(probs, labels)[0]):.2f}"
            f"% ({SURF_SAMPLES} samples, one vmapped forward a batch)")
    with timer.phase("laplace.fit(subset='last')"):
        la = laplace.fit(model, train, estimator="kfac", subset="last")
    with timer.phase("optimize_prior_precision"):
        tuned = la.optimize_prior_precision()
    with timer.phase("predictive(linearized)"):
        lin = la.predictive(test[0][0], method="linearized")
    if not (np.isfinite(lin).all() and np.allclose(lin.sum(-1), 1.0,
                                                   atol=1e-4)):
        raise AssertionError("surface: the linearized predictive is not a "
                             "distribution")
    if counters.read() != counters.want(none):
        raise AssertionError(f"surface tutorial launched {counters.read()}")
    log(f"surface tutorial laplace: last-layer KFAC, tuned "
        f"{json.dumps({k: np.asarray(v).tolist() for k, v in tuned.items()})[:200]}"
        f"; linearized accuracy on one batch "
        f"{float(E.accuracy(lin, test[0][1])):.2f}%")
    log("surface tutorial seconds (Timer): " + json.dumps(
        {k: round(v, 4) for k, v in timer.times.items()}))

    # (b) profile_trace on a kernel path: one ResNet-18 CIFAR f32 update
    r18_cfg = parse_args(R18_ARGV + ["--root_dir", SURF_ROOT])
    r18 = common.build_model(r18_cfg)
    x18 = next(iter(on_card(common.build_data(r18_cfg, splits="train"))))[0]
    kfac18 = estimators.KFAC(r18)
    kfac18.update(x18, generator=gen)                  # warm
    torch.cuda.synchronize()
    counters.reset()
    with tempfile.TemporaryDirectory() as trace_dir:
        with profile_trace(trace_dir):
            kfac18.update(x18, generator=gen)
            torch.cuda.synchronize()
        got = counters.read()
        files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
                 if f.endswith(".json")]
        if len(files) != 1:
            raise AssertionError(f"surface: profile_trace wrote {files}")
        trace_bytes = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
    want = R18_ROUTES[R18_PATHS[0]]
    if (got["patch_gram_tiled"], got["patch_gram_v2"]) != \
            (want["tiled"], want["v2"]):
        raise AssertionError(f"surface: the traced update launched {got}")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    grams = [e for e in kernels if "gram_tf32x3_wgmma_kernel" in e["name"]
             or "gram_wgmma_kernel" in e["name"]]
    reduces = [e for e in kernels if "gram_reduce_kernel" in e["name"]]
    if len(grams) != want["tiled"] + want["v2"] or \
            len(reduces) != len(grams):
        raise AssertionError(
            f"surface: the trace holds {len(grams)} Gram and {len(reduces)}"
            f" reduce kernels, the counters {want['tiled']} + {want['v2']}")
    by_path[SURF_PATHS[0]] = got
    counters.reset()
    log(f"surface profile_trace: {trace_bytes} bytes, {len(events)} events, "
        f"{len(kernels)} kernels; Gram kernels {len(grams)} = "
        f"{got['patch_gram_tiled']} tiled + {got['patch_gram_v2']} v2 "
        f"(counters), {sum(e['dur'] for e in grams):.1f} us on the card "
        f"(+ {sum(e['dur'] for e in reduces):.1f} us in their reduces; "
        f"{smi})")

    # (c) the ensemble's two routes on each side of VMAP_MAX_PIXELS, each
    # held to a member loop written here: ResNet-50 at 224² (the rule's
    # loop, vmap forced on the instance), ResNet-18 CIFAR at 32² (the
    # rule's vmap, the loop forced)
    def rate(fn, images, blocks=3):
        best = float("inf")
        for _ in range(blocks):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return images / best

    def both_routes(model, members, x):
        """{route: (img/s, max |dp| to the witness, peak GiB)}, the rule's
        route first: make_ensemble_fn on an ensemble prepared once, the
        other route forced by the instance's ``vmap_max_pixels``."""
        with torch.no_grad():
            want = torch.stack([torch.softmax(
                functional_call(model, p, (x,)).float(), dim=-1)
                for p in members])
        fwd = E.make_ensemble_fn(model)
        out = {}
        ruled = vmaps(model, x)
        for forced in (False, True):
            with (route_forced(model, 0 if ruled else None) if forced
                  else contextlib.nullcontext()):
                route = "vmap" if vmaps(model, x) else "loop"
                ens = prepare_ensemble(model, members, x)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                got = fwd(ens, x)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                worst = float((got - want).abs().max())
                if not worst <= SURF_ENSEMBLE_TOL:
                    raise AssertionError(
                        f"surface: the {route} route is {worst:.3e} from "
                        f"the member loop (> {SURF_ENSEMBLE_TOL})")
                out[route] = (rate(lambda: fwd(ens, x), x.shape[0],
                                   2 if forced else 3), worst, peak)
                del ens, got
        torch.cuda.empty_cache()
        return out

    def routes_line(out):
        return "; ".join(
            f"{r}{' (forced)' if i else ' (the rule)'} {v[0]:.2f} img/s, "
            f"max |dp| {v[1]:.3e}, peak {v[2]:.2f} GiB"
            for i, (r, v) in enumerate(out.items()))
    r50 = models.resnet50(num_classes=CLASSES, device=dev)
    models.load_jax_variables(r50, models.seeded_variables(r50, 0))
    r50 = r50.to(memory_format=torch.channels_last).eval()
    x50 = nchw_batches(np.random.default_rng(5), 1, BATCH, dev)[0][0]
    tracked = {f"{n}.{leaf}" for n in estimators.KFAC(r50).metas
               for leaf in ("weight", "bias")}
    mean = {k: v.detach() for k, v in r50.named_parameters()}
    g50 = torch.Generator(device=dev).manual_seed(6)
    ensemble = [{k: (v + 1e-3 * v.abs().mean() * torch.randn(
        v.shape, generator=g50, device=dev, dtype=v.dtype))
        if k in tracked else v for k, v in mean.items()}
        for _ in range(SAMPLES)]
    r50_routes = both_routes(r50, ensemble, x50)
    if next(iter(r50_routes)) != "loop":
        raise AssertionError("surface: ResNet-50 at 224² is not routed to "
                             "the member loop")
    log(f"surface resnet50_bnn30_eval_img_s (make_ensemble_fn, "
        f"{x50.shape[-1]}², B={BATCH}, {SAMPLES} members, f32, TF32 off): "
        f"{routes_line(r50_routes)} (bar {SURF_ENSEMBLE_TOL}; {smi})")
    del ensemble, mean, r50
    # ResNet-18 CIFAR, KFAC's posterior from the traced update: the
    # sampled ensemble's two routes, then the linearized predictive's
    # rate beside the sampled one's
    kfac18.invert(float(R18_DAMPING[1]), float(R18_DAMPING[3]))
    ens18 = kfac18.ensemble_params(SAMPLES, generator=gen)
    r18.eval()
    r18_routes = both_routes(r18, ens18, x18)
    if next(iter(r18_routes)) != "vmap":
        raise AssertionError("surface: ResNet-18 at 32² is not routed to "
                             "vmap")
    log(f"surface resnet18 bnn30 ensemble (make_ensemble_fn, 32², "
        f"B={x18.shape[0]}, {SAMPLES} members, f32): "
        f"{routes_line(r18_routes)} ({smi})")
    x18s = [(x18, np.zeros(x18.shape[0], np.int64))]
    lin_rate = rate(lambda: E.eval_bnn_linearized(
        r18, kfac18, x18s, SAMPLES, ensemble_params=ens18), x18.shape[0])
    smp_rate = rate(lambda: E.eval_bnn(
        r18, kfac18, x18s, SAMPLES, ensemble_params=ens18), x18.shape[0])
    log(f"surface resnet18 linearized predictive: {lin_rate:.2f} img/s "
        f"(one vmapped jvp a batch, {SAMPLES} samples, B={x18.shape[0]}); "
        f"sampled {smp_rate:.2f} img/s; ratio {smp_rate / lin_rate:.2f}x "
        f"({smi})")
    del ens18
    torch.cuda.empty_cache()

    # (d) every plot function to PNG and SVG, from (a)'s results
    fig_t0 = time.perf_counter()
    root = os.path.abspath(os.path.join(SURF_ROOT, "figures"))
    os.makedirs(root, exist_ok=True)
    probs, labels, stats = results["KFAC"]
    nn_probs, _ = E.eval_nn(model, test)
    ood = [(torch.flip(x, dims=(-1,)) * -1.0 + x.max(), y) for x, y in test]
    ood_probs, _ = E.eval_nn(model, ood)
    bnn_ood, _, _ = E.eval_bnn(model, fitted["KFAC"], ood,
                               samples=SURF_SAMPLES, generator=gen)
    eig = np.concatenate([np.linalg.eigvalsh(f["a"].double().cpu().numpy())
                          for f in fitted["KFAC"].state.values()])
    ritz = np.linalg.eigvalsh(
        fitted["KFAC"].state["fc3"]["a"].double().cpu().numpy())
    attack = {"steps": [0.0, 0.1, 0.2], "nn": {}, "bnn": {}}
    for eps in attack["steps"]:
        nn_s = E.eval_fgsm(model, test, epsilon=eps)[2]
        bnn_s = E.eval_fgsm_bnn(model, fitted["KFAC"], test,
                                samples=4, epsilon=eps, generator=gen)[2]
        for key in ("acc", "ece1", "ent"):
            attack["nn"].setdefault(key, []).append(nn_s[key])
            attack["bnn"].setdefault(key, []).append(bnn_s[key])
    hyper = {"norms": [], "scales": [], "cost": [], "acc": []}
    for norm, scale in ((1.0, 5e4), (10.0, 5e4), (1.0, 5e3)):
        fitted["KFAC"].invert(norm, scale)
        p, y, _ = E.eval_bnn(model, fitted["KFAC"], test[:2], samples=4,
                             generator=gen)
        hyper["norms"].append([norm])
        hyper["scales"].append([scale])
        hyper["cost"].append(float(E.negative_log_likelihood(p, y)))
        hyper["acc"].append(float(E.accuracy(p, y)))
    lgen = torch.Generator(device=dev).manual_seed(7)
    line = loss_landscape.loss1d(model, train_np[:2], test_np[:2], lgen,
                                 steps=9)
    surface = loss_landscape.loss2d(model, train_np[:2], lgen, xsteps=7,
                                    ysteps=7)

    class _Cfg:
        data = "mnist"

    def save(fig, pth):
        fig.savefig(pth, format=pth.rsplit(".", 1)[-1], dpi=300,
                    bbox_inches="tight")
        return fig
    calls = {
        "training_curves": lambda pth: plot.training_curves(
            {"loss": stats["nll"], "val_acc": stats["acc"]}, pth),
        "factor_norms": lambda pth: plot.factor_norms(
            fitted["KFAC"].state, pth),
        "calibration": lambda pth: plot.calibration(
            probs, labels, pth, label="BNN-KFAC", color="crimson"),
        "reliability_diagram": lambda pth: plot.reliability_diagram(
            probs, labels, path=pth),
        "confidence_hist": lambda pth: plot.confidence_hist(probs, pth),
        "inv_ecdf_vs_pred_entropy": lambda pth:
            plot.inv_ecdf_vs_pred_entropy(ood_probs, color="crimson",
                                          label="OOD", path=pth),
        "true_false_ecdf": lambda pth: plot.true_false_ecdf(
            nn_probs, labels, pth),
        "entropy_hist": lambda pth: plot.entropy_hist(probs, bnn_ood, pth),
        "eigenvalue_histogram": lambda pth: plot.eigenvalue_histogram(
            eig, pth, label="KFAC"),
        "spectral_density": lambda pth: plot.spectral_density(
            ritz, np.full(len(ritz), 1.0 / len(ritz)), pth,
            label="fc3 A"),
        # JAX's rule writes a path without '.pdf' as '<path>_fgsm.pdf':
        # the figure it returns is saved as plot._save saves
        "adversarial_results": lambda pth: save(plot.adversarial_results(
            attack["steps"], attack["nn"], attack["bnn"]), pth),
        "hyper_results": lambda pth: plot.hyper_results(hyper, pth),
        "plot_loss1d": lambda pth: plot.plot_loss1d(line, pth),
        "plot_surfaces": lambda pth: plot.plot_surfaces(surface, pth),
    }
    missing = {f for f in dir(plot) if not f.startswith("_")
               and callable(getattr(plot, f))
               and getattr(getattr(plot, f), "__module__", "") == plot.__name__
               } - set(calls) - {"ood_panels"}
    if missing:
        raise AssertionError(f"surface: plot functions not drawn: {missing}")
    boxes = []
    text = png.Canvas.text

    def recording_text(self, x, y, s, size, color, halign="left",
                       valign="baseline", rotation=0.0):
        text(self, x, y, s, size, color, halign, valign, rotation)
        if s.strip():
            w = png.text_width(s, size)
            dx = -w * {"left": 0.0, "center": 0.5, "right": 1.0}[halign]
            dy = size / 1000.0 * {"baseline": 0.0, "bottom": 207,
                                  "top": -718, "center": -255.5}[valign]
            t = math.radians(rotation)
            u = np.array([dx, dx + w, dx, dx + w])
            v = np.array([dy - 0.2 * size] * 2 + [dy + 0.75 * size] * 2)
            px = self._px(np.stack([x + math.cos(t) * u - math.sin(t) * v,
                                    y + math.sin(t) * u + math.cos(t) * v],
                                   axis=1))
            boxes[-1].append((s, px.min(0), px.max(0)))
    savefig = figure.Figure.savefig

    def recording_savefig(self, path, **kw):
        boxes.append([])
        return savefig(self, path, **kw)
    sizes, seconds = {}, {}
    png.Canvas.text = recording_text
    figure.Figure.savefig = recording_savefig
    try:
        for name, call in calls.items():
            for ext in ("pdf", "svg", "png"):
                path = os.path.join(root, f"{name}.{ext}")
                t0 = time.perf_counter()
                out = call(path)
                seconds[path] = time.perf_counter() - t0
                sizes[path] = os.path.getsize(path)
            fig = out.figure if isinstance(out, figure.Axes) else out
            # the PNG: its size, ink in the axes and in each string's box
            img = images.open_rgb(os.path.join(root, f"{name}.png"))
            want_hw = (round(fig.figsize[1] * 300), round(fig.figsize[0] * 300))
            if img.shape[:2] != want_hw:
                raise AssertionError(f"surface: {name}.png is {img.shape}, "
                                     f"not {want_hw}")
            dark = img.min(axis=2) < 250
            for ax in fig.axes:
                x0, y0, w, h = ax.rect
                r0, r1 = round((1 - y0 - h) * want_hw[0]), \
                    round((1 - y0) * want_hw[0])
                c0, c1 = round(x0 * want_hw[1]), round((x0 + w) * want_hw[1])
                if not dark[r0 + 4:r1 - 4, c0 + 4:c1 - 4].any():
                    raise AssertionError(f"surface: {name}.png has no ink "
                                         f"inside the axes at {ax.rect}")
            for s, lo, hi in boxes[-1]:
                c0, r0 = np.floor(lo).astype(int)
                c1, r1 = np.ceil(hi).astype(int) + 1
                if not dark[max(r0, 0):r1, max(c0, 0):c1].any():
                    raise AssertionError(f"surface: {name}.png: no ink in "
                                         f"the box of {s!r}")
            # the SVG: the strings of the same figure's PDF
            want_s = pdf.read_pdf(os.path.join(root, f"{name}.pdf"))
            got_s = svg.read_svg(os.path.join(root, f"{name}.svg"))
            stand_in = {ord(k): v for k, v in pdf._STAND_INS.items()}
            if [t.translate(stand_in) for t in got_s["strings"]] != \
                    want_s["strings"] or \
                    got_s["painted"] != want_s["painted"]:
                raise AssertionError(f"surface: {name}.svg does not hold "
                                     "the PDF's strings and paths")
    finally:
        png.Canvas.text = text
        figure.Figure.savefig = savefig
    plot.ood_panels(_Cfg, nn_probs, probs, ood_probs, bnn_ood, labels,
                    os.path.join(root, "ood"))
    for suffix in FIG_OOD:
        sizes[os.path.join(root, "ood") + suffix] = pdf.read_pdf(
            os.path.join(root, "ood") + suffix)["bytes"]
    slow = max((v, k) for k, v in seconds.items() if k.endswith(".png"))
    n_png = sum(1 for k in sizes if k.endswith(".png"))
    n_svg = sum(1 for k in sizes if k.endswith(".svg"))
    log(f"surface figures: {len(sizes)} files ({n_png} PNG at 300 dpi, "
        f"{n_svg} SVG, {len(sizes) - n_png - n_svg} PDF), "
        f"{sum(sizes.values())} bytes, "
        f"{time.perf_counter() - fig_t0:.1f} s (inputs included); PNG "
        f"{sum(v for k, v in seconds.items() if k.endswith('.png')):.1f} s,"
        f" SVG {sum(v for k, v in seconds.items() if k.endswith('.svg')):.2f}"
        f" s; slowest {os.path.basename(slow[1])} {slow[0]:.3f} s; "
        f"{sum(len(b) for b in boxes)} string boxes inked")
    if counters.read() != counters.want(none):
        raise AssertionError(f"surface figures launched {counters.read()}")
    total = time.perf_counter() - t_phase
    log(f"surface phase: {total:.1f} s, "
        f"{'within' if total <= SURF_BUDGET_S else 'OVER'} its "
        f"{SURF_BUDGET_S:.0f} s budget ({smi})")
    return by_path


@contextlib.contextmanager
def route_forced(model, most):
    """The ensemble route of ``model`` forced for the block by its
    instance's ``vmap_max_pixels`` (None: vmap, 0: the member loop; see
    ``evaluate.vmaps``), the instance's own limit restored after."""
    own = model.__dict__.get("vmap_max_pixels", route_forced)
    model.vmap_max_pixels = most
    try:
        yield model
    finally:
        if own is route_forced:
            del model.vmap_max_pixels
        else:
            model.vmap_max_pixels = own


def vmap_sweep(models, smi, dev):
    """The ensemble's two routes timed over ``SWEEP_CASES`` (seeded
    weights, channels_last as ``build_model`` lays them out on the card,
    each member every float parameter plus 1e-3 of its mean magnitude in
    seeded noise): ms of one ``make_ensemble_fn`` call under vmap and in
    the member loop, best of 2 after a warm one, beside the route
    ``evaluate.vmaps`` picks. Prints; decides nothing."""
    import numpy as np
    import torch
    from curvature_tpu_torch import eval as E
    from curvature_tpu_torch.eval.evaluate import prepare_ensemble, vmaps
    t_sweep = time.perf_counter()
    for name, kw, batch, sides in SWEEP_CASES:
        model = models.build(name, num_classes=CLASSES, device=dev, **kw)
        models.load_jax_variables(model, models.seeded_variables(model, 0))
        model = model.to(memory_format=torch.channels_last).eval()
        gen = torch.Generator(device=dev).manual_seed(8)
        members = [{k: v.detach() + 1e-3 * v.detach().abs().mean()
                    * torch.randn(v.shape, generator=gen, device=dev)
                    for k, v in model.named_parameters()}
                   for _ in range(SAMPLES)]
        fwd = E.make_ensemble_fn(model)
        for side in sides:
            x = torch.from_numpy(np.random.default_rng(side).standard_normal(
                (batch, 3, side, side)).astype(np.float32)).to(dev)
            x = x.contiguous(memory_format=torch.channels_last)
            ruled = "vmap" if vmaps(model, x) else "loop"
            ms = {}
            for route, most in (("vmap", None), ("loop", 0)):
                with route_forced(model, most):
                    ens = prepare_ensemble(model, members, x)
                    fwd(ens, x)
                    best = float("inf")
                    for _ in range(2):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        fwd(ens, x)
                        torch.cuda.synchronize()
                        best = min(best, time.perf_counter() - t0)
                    ms[route] = 1e3 * best
                    del ens
            faster = min(ms, key=ms.get)
            log(f"vmap sweep {name} {side}² B={batch} S={SAMPLES}: vmap "
                f"{ms['vmap']:.1f} ms, loop {ms['loop']:.1f} ms; the rule "
                f"picks {ruled}{'' if ruled == faster else ' (the slower)'}")
        del model, members, fwd
        torch.cuda.empty_cache()
    log(f"vmap sweep: {time.perf_counter() - t_sweep:.1f} s ({smi})")


# -- the batched symmetric Gram (--grams) -------------------------------------

#: --grams: the batched f32 symmetric Gram at the fit cells' shapes, each
#: (name, rows shape, segment lengths of a ragged case or None, ones
#: column): GPT-2's stacked A factors ([12, 8192, 769] and [12, 8192,
#: 3073] with the ones column the pre-pass writes) and c_attn's G,
#: Moonlight's dense down_proj A and a routed layer-side (16 held experts
#: over 12,288 rows, 330-1,583 each); then a transposed view (a grouped
#: layer's tokens), a ragged case with an empty segment, and more segments
#: than one launch takes (two launches)
BATCHED_CASES = [
    ("gpt2_a_769", (12, 8192, 768), None, True),
    ("gpt2_a_3073", (12, 8192, 3072), None, True),
    ("gpt2_g_2304", (12, 8192, 2304), None, False),
    ("moonlight_a_11264", (8192, 11264), None, False),
    ("moonlight_routed_2048", (12288, 2048), "routed", False),
    ("transposed_view", (3, 4096, 300), "view", False),
    ("ragged_empty_ones", (1000, 257), [0, 0, 333, 1000], True),
    ("two_slices", (130, 300, 320), None, False),
]
#: --grams: the gate's sweep, the kernel against cuBLAS's strict-f32
#: product over F, for segments of each row count, one segment and 16
GATE_SWEEP_F = (128, 192, 256, 320, 384, 512, 769, 1024, 1408, 2048, 3072,
                4096)
GATE_SWEEP_ROWS = (128, 256, 512, 768, 2048, 8192)
GATE_SWEEP_SEGMENTS = (1, 16)


def routed_lengths(total=12288, n=16, lo=330, hi=1583, seed=0):
    """``n`` segment lengths in [lo, hi] summing to ``total``: a routed
    layer of 16 held experts as the Moonlight cell loads them."""
    import numpy as np
    rng = np.random.default_rng(seed)
    while True:
        w = rng.uniform(lo, hi, n)
        lens = np.floor(w / w.sum() * total).astype(int)
        lens[-1] += total - lens.sum()
        if lens.min() >= lo and lens.max() <= hi:
            return lens.tolist()


def batched_input(shape, kind, seed):
    """(x, offsets) of a BATCHED_CASES entry on the card."""
    import numpy as np
    import torch
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).cuda()
    if kind == "routed":
        return x, [0] + np.cumsum(routed_lengths(shape[0])).tolist()
    if kind == "view":
        return x.transpose(0, 1).contiguous().transpose(0, 1), None
    return x, kind


def check_batched_sym(tsg):
    """BATCHED_CASES through ``sym_gram_batched``: the pre-pass bit for bit
    its plain version, one launch a call, two launches the same bits, each
    Gram bitwise symmetric and off its diagonal within CORR_OFF_RTOL of a
    float64 Gram, beside the error of the cuBLAS Gram it replaces; timed
    (CUDA events, the profiler's device time) against its bound and that
    route (cuBLAS's strict-f32 ``a^T a``: the batched matmul, after the
    ones column's concatenation, or one matmul an expert and a stack).
    Returns the records."""
    import torch
    records = []
    for i, (name, shape, kind, ones) in enumerate(BATCHED_CASES):
        x, offsets = batched_input(shape, kind, 10 + i)
        lengths = tsg._segment_table(x, offsets)[2]
        f = x.shape[-1] + ones
        # the pre-pass of the first launch's segments, as the Gram runs it
        px = x[:tsg.MAX_SEGMENTS] if len(lengths) > tsg.MAX_SEGMENTS else x
        with torch.cuda.device(x.device):
            _, op = next(tsg._presplits(x, offsets, ones))
        if not torch.equal(op, tsg.tf32_presplit_batched_plain(px, offsets,
                                                               ones)):
            raise AssertionError(f"{name}: the batched pre-pass differs "
                                 "from its plain version")
        del op
        segs = tsg.segments_of(x, offsets)
        before = tsg.sym_gram_batched.launches
        got = tsg.sym_gram_batched(x, offsets, ones)
        if tsg.sym_gram_batched.launches != before + -(
                -len(segs) // tsg.MAX_SEGMENTS):
            raise AssertionError(f"{name}: not one launch a slice of "
                                 f"{tsg.MAX_SEGMENTS} segments")
        if not torch.equal(got, tsg.sym_gram_batched(x, offsets, ones)):
            raise AssertionError(f"{name}: two launches differ")
        got = got.reshape(-1, f, f)
        if not torch.equal(got, got.mT):
            raise AssertionError(f"{name}: not bitwise symmetric")
        def call(x=x, offsets=offsets, ones=ones):
            return tsg.sym_gram_batched(x, offsets, ones)

        def library(x=x, offsets=offsets, ones=ones, segs=segs):
            if offsets is not None:
                return torch.stack([a.T @ a for a in (
                    tsg._with_ones(s, ones) for s in segs)])
            a = tsg._with_ones(x, ones)
            return a.transpose(-1, -2) @ a
        lib = library().reshape(-1, f, f)
        worst = lib_worst = 0.0
        for g, b, s in zip(got, lib, segs):
            if s.shape[0] == 0:
                if g.any():
                    raise AssertionError(f"{name}: an empty segment's Gram "
                                         "is not zero")
                continue
            s = tsg._with_ones(s.double(), ones)
            want = s.T @ s
            worst = max(worst, off_diagonal_err(g, want))
            lib_worst = max(lib_worst, off_diagonal_err(b, want))
        del lib
        log(f"  sym_gram_batched {name} {tuple(x.shape)} offsets "
            f"{'ragged' if offsets else 'uniform'} ones={ones}: "
            f"off-diagonal err {worst:.3e} of the largest off-diagonal "
            f"float64 entry (bar {CORR_OFF_RTOL}); cuBLAS strict f32 "
            f"{lib_worst:.3e}")
        if not worst <= CORR_OFF_RTOL:
            raise AssertionError(f"{name}: off-diagonal error {worst:.3e} "
                                 f"over {CORR_OFF_RTOL}")
        rows = sum(s.shape[0] for s in segs)
        splits, _ = tsg.split_plan(max(lengths), f, False,
                                   tsg._resident_blocks(0, False),
                                   len(lengths))
        records.append(dict(
            name=f"sym_gram_batched_{name}", function="sym_gram_batched",
            counter="sym_gram_batched", dtype="f32",
            source="curvature_tpu_torch/ops/cuda/csrc/sym_gram.cu",
            shape=list(x.shape), segments=len(segs), ones=ones,
            ragged=offsets is not None, splits=splits,
            off_diagonal_err=worst, library_off_diagonal_err=lib_worst,
            launches=None, launches_by_path=None, ms=cuda_ms(call),
            call=call,
            library_ms=cuda_ms(library),
            library_call="cuBLAS a^T a, strict f32 (TF32 off)",
            **bounds(rows * f * (f + 1), x.numel() * 4
                     + len(segs) * f * f * 4, "f32")))
        del x, got
        torch.cuda.empty_cache()
    for rec in records:
        by_kernel = device_ms_by_kernel(rec.pop("call"))
        rec["device_ms"] = sum(by_kernel.values())
        rec["device_ms_presplit"] = sum(
            v for k, v in by_kernel.items() if "presplit_kernel" in k)
        rec["bound_share"] = rec["bound_ms"] / rec["device_ms"]
        log(f"{rec['name']}: {rec['ms']:.4f} ms, device "
            f"{rec['device_ms']:.4f} ms (pre-pass "
            f"{rec['device_ms_presplit']:.4f}), {rec['splits']} split(s), "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
            f"{100 * rec['bound_share']:.1f}%), cuBLAS strict f32 "
            f"{rec['library_ms']:.4f} ms")
    return records


def device_ms(fn, tries=3):
    """The summed device time per call of ``fn`` (device_ms_by_kernel),
    profiled again where a profile came back with no kernel events."""
    for _ in range(tries):
        ms = sum(device_ms_by_kernel(fn, calls=3).values())
        if ms > 0:
            return ms
    raise RuntimeError("the profiler recorded no device time")


def sweep_gate(tsg):
    """The batched kernel against cuBLAS's strict-f32 product over
    GATE_SWEEP_F for every segment count and row count of
    GATE_SWEEP_SEGMENTS x GATE_SWEEP_ROWS: each one's device time (the
    profiler's kernels, what a device-paced fit waits for) and its
    back-to-back time (CUDA events; where it exceeds the device time, the
    host's cost of a call, what a host-paced fit waits for). Returns the
    rows; for each (segments, rows), the least F of the sweep from which
    the kernel wins at every larger F on device time and on both times
    (None: nowhere); and the shapes where the gate and the win on both
    disagree."""
    import torch
    rows_out, crossover, disagree = [], {"device": {}, "both": {}}, []
    for segs in GATE_SWEEP_SEGMENTS:
        for n in GATE_SWEEP_ROWS:
            wins = {"device": [], "both": []}
            for f in GATE_SWEEP_F:
                x = torch.randn((segs, n, f), device="cuda")

                def kernel():
                    return tsg.sym_gram_batched(x)

                def cublas():
                    return x.mT @ x
                row = {"segments": segs, "rows": n, "f": f,
                       "kernel_device_ms": device_ms(kernel),
                       "cublas_device_ms": device_ms(cublas),
                       "kernel_ms": cuda_ms(kernel, min_ms=20),
                       "cublas_ms": cuda_ms(cublas, min_ms=20),
                       "gate": tsg.batched_gate(segs, segs * n, f)}
                rows_out.append(row)
                device = row["kernel_device_ms"] < row["cublas_device_ms"]
                both = device and row["kernel_ms"] < row["cublas_ms"]
                wins["device"].append(device)
                wins["both"].append(both)
                if row["gate"] != both:
                    disagree.append([segs, n, f, row["gate"]])
                log(f"  gate sweep: {segs} x [{n}, {f}]: device kernel "
                    f"{row['kernel_device_ms']:.4f} ms, cuBLAS "
                    f"{row['cublas_device_ms']:.4f} ms "
                    f"({row['cublas_device_ms'] / row['kernel_device_ms']:.2f}"
                    f"x); back to back {row['kernel_ms']:.4f} / "
                    f"{row['cublas_ms']:.4f} ms; gate {row['gate']}")
                del x
            for key, won in wins.items():
                least = None
                for f, w in zip(reversed(GATE_SWEEP_F), reversed(won)):
                    if not w:
                        break
                    least = f
                crossover[key][f"{segs}x{n}"] = least
    log(f"gate sweep crossover (least F won through the sweep's top), on "
        f"device time and on both times: {json.dumps(crossover)}; the gate "
        f"against a win on both, where they differ ([segments, rows, F, "
        f"gate]): {json.dumps(disagree)}")
    return rows_out, crossover, disagree


def expected_sym(est, spans):
    """The factor spans whose Gram takes the batched kernel by the seam's
    own decision (``grams.takes_kernel``) on their shapes alone: stacked
    and plain dense or conv Grams over their tokens (``kfac._token_count``),
    routed sides over their rows (one given label, S = 1); the kernel
    routes (corr, tiled, v2), tap and rows take none."""
    import math
    import torch
    from curvature_tpu_torch.estimators.grams import takes_kernel
    from curvature_tpu_torch.estimators.kfac import _token_count
    probe = torch.empty(0, device=est.device)
    n = 0
    for s in spans:
        meta, side, route = est.metas[s.attrs["layer"]], s.attrs["side"], \
            s.attrs["route"]
        shape = s.attrs.get("shape")
        f = meta.mat_cols if side == "a" else meta.out_features
        if route == "routed":
            segs, rows = s.attrs["experts"], s.attrs["rows"]
        elif route == "stacked":
            segs = shape[0] if side == "a" else shape[1]
            rows = math.prod(shape[:-1])
        elif route == "patches" and meta.kind == "conv":
            segs, rows = 1, _token_count(meta, shape)
        elif route in ("patches", "plain"):
            segs, rows = 1, math.prod(shape[:-1])
        else:
            continue
        n += takes_kernel(probe, est.dtype, est.use_kernels, (segs, rows, f))
    return n


def fit_launches(estimators, models, tsg, dev):
    """One update of each fit cell's model (the cells' shapes; one given
    label): the batched kernel's launches, the factor spans' ``gram``
    counts, both held to the shape-alone expectation (GPT-2: all 8
    stacked factors, no matmul Gram; Moonlight: every routed layer-side
    one launch), the routes of the matmul Grams (a batched one over more
    than ``grams.GRAM_CHUNK`` tokens is cut into chunks), and
    ``update_state`` ms with the kernel against
    ``use_kernels=False`` (the matmul Grams; on ResNet-50 the patch
    kernels too). Returns {model: record}."""
    import collections
    import torch
    from curvature_tpu_torch.utils import monitor
    out = {}
    cases = [
        ("gpt2-124m", lambda: models.gpt2(50257, scan_blocks=True,
                                          device=dev),
         (8, 1024), 50257, dict(loss="lm", layer_filter="h.*")),
        ("moonlight-16b-a3b", lambda: models.moonlight_16b_a3b(
            num_hidden_layers=6, held=(0, 16), device=dev),
         (2, 4096), 163840, dict(loss="lm", layer_filter="model.layers.*")),
        ("resnet50", lambda: models.resnet50(num_classes=1000, device=dev)
         .to(memory_format=torch.channels_last), (128, 3, 224, 224), 1000,
         {}),
    ]
    gen = torch.Generator(device=dev).manual_seed(5)
    for name, build, shape, classes, kw in cases:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build()
        if len(shape) == 2:
            x = torch.randint(0, classes, shape, device=dev, generator=gen)
            labels = torch.randint(0, classes, (1,) + shape, device=dev,
                                   generator=gen)
        else:
            x = torch.randn(shape, device=dev, generator=gen).contiguous(
                memory_format=torch.channels_last)
            labels = torch.randint(0, classes, (1, shape[0]), device=dev,
                                   generator=gen)
        est = estimators.KFAC(model, **kw)
        est.update(x, labels=labels)
        torch.cuda.synchronize()
        before = tsg.sym_gram_batched.launches
        with monitor.tracing():
            monitor.clear_spans()
            est.update(x, labels=labels)
            spans = [s for s in monitor.spans() if s.name == "factor"]
        monitor.clear_spans()
        launches = tsg.sym_gram_batched.launches - before
        grams = collections.Counter(s.attrs["gram"] for s in spans)
        want = expected_sym(est, spans)
        routed = [s for s in spans if s.attrs["route"] == "routed"]

        def state_ms(use):
            est.use_kernels = use
            cap = est.capture(x, labels=labels)
            with torch.no_grad():
                est.update_state(est.state, cap)
                ms = cuda_ms(lambda: est.update_state(est.state, cap),
                             min_ms=200, warmup=1)
            del cap
            return ms
        kernel_ms, matmul_ms = state_ms(True), state_ms(False)
        est.use_kernels = True
        rec = {"launches_per_update": launches, "expected": want,
               "grams": dict(grams), "matmul_routes": dict(
                   collections.Counter(
                       f"{s.attrs['route']}/{s.attrs['side']}"
                       for s in spans if s.attrs["gram"] == "matmul")),
               "routed_sym": sum(
                   s.attrs["gram"] == "sym" for s in routed),
               "routed_sides": len(routed),
               "update_state_ms": kernel_ms,
               "update_state_ms_matmul": matmul_ms,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"fit launches {name}: {json.dumps(rec)}")
        if not launches == grams["sym"] == want:
            raise AssertionError(f"{name}: {launches} launches, "
                                 f"{grams['sym']} sym spans, {want} expected")
        if name == "gpt2-124m" and dict(grams) != {"sym": 8}:
            raise AssertionError(f"{name}: grams {dict(grams)}, not 8 sym")
        if name == "moonlight-16b-a3b" and (
                not routed or rec["routed_sym"] != len(routed)):
            raise AssertionError(f"{name}: {rec['routed_sym']} of "
                                 f"{len(routed)} routed sides took the "
                                 "kernel")
        out[name] = rec
        del est, model, x, labels, spans
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also print a device-time breakdown of one update "
                         "of each path")
    ap.add_argument("--kernels", action="store_true",
                    help="build and check the kernels, print their records "
                         "and the f32 sym_gram split sweep (SPLIT_SWEEP), "
                         "and stop (no paths, no result line)")
    ap.add_argument("--grams", action="store_true",
                    help="build the kernels, check and time the batched "
                         "f32 symmetric Gram at the fit cells' shapes, "
                         "sweep its gate against cuBLAS, count its launches "
                         "an update on the three fit models, and stop (no "
                         "result line)")
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
    ap.add_argument("--subspace", action="store_true",
                    help="build the kernels, run the exact-curvature phase "
                         "(Subspace, Lanczos, fidelity, influence) only and "
                         "stop (no result line)")
    ap.add_argument("--moe", action="store_true",
                    help="build the kernels, run the mixture-of-experts "
                         "phase (and KFAC's stack_grams/fused_g) only and "
                         "stop (no result line)")
    ap.add_argument("--parallel", action="store_true",
                    help="build the kernels, run the parallel phase (a "
                         "world of one over NCCL, two gloo ranks on the "
                         "card) only and stop (no result line)")
    ap.add_argument("--parallel_rank", metavar="DIR", default="",
                    help=argparse.SUPPRESS)
    ap.add_argument("--mesh_axes", action="store_true",
                    help="build the kernels, run the mesh-axes phase (the "
                         "model, tensor, seq and expert axes on two gloo "
                         "ranks of the card) only and stop (no result line)")
    ap.add_argument("--mesh_axes_rank", metavar="DIR", default="",
                    help=argparse.SUPPRESS)
    ap.add_argument("--surface", action="store_true",
                    help="build the kernels, run the public-surface phase "
                         "(the tutorial through the exported names, "
                         "profile_trace of a kernel path, the ensemble's "
                         "vmap and loop routes against a member loop, every "
                         "figure in PNG and SVG), then the routes' sweep "
                         "over SWEEP_CASES, and stop (no result line)")
    ap.add_argument("--images", action="store_true",
                    help="build the kernels and the image decoders, run the "
                         "image-folder phase (the fixtures against PIL's "
                         "decodes, the host rates, the folder CLIs) only "
                         "and stop (no result line)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import numpy as np
    import torch
    if args.mesh_axes_rank:
        # one rank of the mesh-axes phase; its device is in the phase's
        # config (the card, or the CPU of a dry run); prints no result
        return mesh_axes_rank(args.mesh_axes_rank)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.parallel_rank:
        # one rank of the parallel phase's gloo job; prints no result
        return parallel_rank(args.parallel_rank)

    try:
        from curvature_tpu_torch import estimators, models
        from curvature_tpu_torch.data import images, native
        from curvature_tpu_torch.eval import eval_nn
        from curvature_tpu_torch.ops import corr_gram as tcorr
        from curvature_tpu_torch.ops.cuda import build
        from curvature_tpu_torch.ops.cuda import corr_gram as ccg
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
    runs_moe = not any((args.hyper, args.grouped, args.training, args.zoo,
                        args.transformers, args.subspace, args.parallel,
                        args.lm, args.kernels, args.mesh_axes, args.images,
                        args.surface, args.grams))
    moe_model = prepare_moe_model(models) if runs_moe else None
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        # the image decoders' g++ build beside the nvcc ones
        gxx = pool.submit(native.build, images.SOURCE, "curvimages",
                          images.GXX_FLAGS)
        reports = build.build_all(force=True)
        log(f"g++ build of {images.SOURCE.name}: {gxx.result().name}")
    if moe_model is not None:
        moe_model.result()          # nothing else on the host while timing
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
    if args.subspace:
        t0 = time.perf_counter()
        subspace_phase(estimators, models, Counters(tpg, tsg), smi, dev,
                       args.profile)
        log(f"subspace phase: {time.perf_counter() - t0:.1f} s ({smi})")
        return 0
    if args.moe:
        t0 = time.perf_counter()
        moe_phase(estimators, models, Counters(tpg, tsg), smi, dev,
                  args.profile, moe_model)
        log(f"moe phase: {time.perf_counter() - t0:.1f} s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
        return 0
    if args.parallel:
        parallel_phase(estimators, models, Counters(tpg, tsg), smi, dev)
        log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            " GiB")
        return 0
    if args.mesh_axes:
        mesh_axes_phase(estimators, models, Counters(tpg, tsg), smi, dev)
        log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            " GiB")
        return 0
    if args.surface:
        surface_phase(estimators, models, Counters(tpg, tsg), smi, dev)
        vmap_sweep(models, smi, dev)
        log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            " GiB")
        return 0
    if args.images:
        images_phase(Counters(tpg, tsg), smi)
        log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
            " GiB")
        return 0
    if args.grams:
        t0 = time.perf_counter()
        log("sym_gram_batched at the fit cells' shapes:")
        records = check_batched_sym(tsg)
        sweep, crossover, disagree = sweep_gate(tsg)
        fits = fit_launches(estimators, models, tsg, dev)
        print(json.dumps({"grams": records, "gate_sweep": sweep,
                          "gate_crossover": crossover,
                          "gate_disagrees": disagree, "fit_launches": fits,
                          "card": smi}))
        log(f"grams phase: {time.perf_counter() - t0:.1f} s; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
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
        records += check_corr_kernel(ccg, tcorr, dtype)
    for rec in records:
        fam = {"sym_gram": "sym", "corr_gram": "corr"}.get(
            rec["function"], "patch")
        mod = {"sym": tsg, "patch": tpg}.get(fam)
        edge = ccg.TILE if fam == "corr" else mod.BF16_TILE \
            if rec["dtype"] == "bf16" else mod.F32_TILE
        kernel = KERNEL_OF[fam, rec["dtype"]]
        if fam == "corr" and rec["dtype"] == "bf16":
            how = (f"3xTF32 wgmma m64n{edge}k8 on tf32 tensor cores, bf16 "
                   "widened exactly (zero lo halves)")
        elif rec["dtype"] == "f32":
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
        dict(none, patch_gram_tiled=3 * UPDATES, patch_gram_v2=UPDATES,
             corr_gram=R50_CORR * UPDATES))
    ensemble, _ = laplace_tail(est, model, test_data, gen, counters, "kfac")
    counters.reset()
    nn_probs, labels = eval_nn(model, test_data)
    if counters.read() != counters.want():
        raise AssertionError(f"eval_nn launched {counters.read()}")
    log(f"nn metrics (random weights, {2 * BATCH} synthetic images): "
        f"{json.dumps(prob_stats(nn_probs, labels, 'nn'))}")

    # 3b. bf16 at B=32: layer2.0.conv2 through the v2 kernel in bf16
    est16 = estimators.KFAC(model, compute_dtype=torch.bfloat16)
    by_path[PATHS[1]] = drive_updates(
        est16, batches_b32, gen, counters, PATHS[1],
        dict(none, patch_gram_v2=UPDATES, corr_gram=R50_CORR * UPDATES))

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
        # zoo's records count the zoo's paths, below; corr_gram's count
        # its wrapper on every path)
        base = rec["name"].split("_bf16")[0]
        r18 = base.endswith("_resnet18")
        zoo = base in ZOO_RECORD_PATHS or base in TRANSFORMER_RECORD_PATHS
        paths = (() if zoo and base != "corr_gram" else
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
    # the ladder's rates: informative lines, no benchmark metric (the bnn30
    # evals on one test batch)
    for kind, (e, ens) in lad.items():
        if kind != "inf":                  # INF runs no update pass
            log(f"ladder {kind}: {best_rate(e, batches, gen, BATCH):.2f} "
                f"update img/s (f32 B={BATCH} MC=1, best of 3 blocks of "
                f"{UPDATES} updates; {smi})")
        log(f"ladder {kind}: {eval_rate(model, e, test_data[:1], ens):.2f} "
            f"bnn30 eval img/s (best of 3 blocks of {BATCH} images x "
            f"{SAMPLES} samples; {smi})")
    log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    add_device_times(records)
    # the batched symmetric kernel at the fit cells' shapes; its records
    # count the wrapper's launches on every path, whatever the shape
    batched = check_batched_sym(tsg)
    for rec in batched:
        rec["launches_by_path"] = {p: got["sym_gram_batched"]
                                   for p, got in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
    records += batched
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
    # 5b. the image-folder loaders and their CLIs (ResNet-50 from a JPEG
    # folder, the art OOD chain, GTSRB's PPMs)
    img_by_path = images_phase(counters, smi, rates[PATHS[0]])
    count_record_launches(records, img_by_path, IMG_RECORD_PATHS)
    torch.cuda.empty_cache()
    # 5c. the figures: the --plot CLIs' files above, visualize over their
    # roots
    figures_phase(counters, smi)
    torch.cuda.empty_cache()
    # 5d. the JAX package's public surface: the tutorial through the
    # exported names, profile_trace of a kernel path, the ensemble's two
    # routes against a member loop, every figure in PNG and SVG
    surf_by_path = surface_phase(estimators, models, counters, smi, dev)
    count_record_launches(records, surf_by_path, SURF_RECORD_PATHS)
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

    # -- 9. the exact curvature: the Subspace rows and checks, SWAG, the
    # fidelity and subspace CLIs, self-influence -------------------------
    t0 = time.perf_counter()
    sub_by_path = subspace_phase(estimators, models, counters, smi, dev,
                                 args.profile)
    log(f"subspace phase: {time.perf_counter() - t0:.1f} s ({smi})")
    count_record_launches(records, sub_by_path, SUB_RECORD_PATHS)
    torch.cuda.empty_cache()

    # -- 10. the causal-LM path: GPT-2 124M, the ladder, the token CLIs ----
    t0 = time.perf_counter()
    _, lm_by_path = lm_phase(estimators, models, counters, smi, dev,
                             args.profile)
    log(f"lm phase: {time.perf_counter() - t0:.1f} s ({smi})")
    count_record_launches(records, lm_by_path, {})
    torch.cuda.empty_cache()

    # -- 11. the mixture of experts: the Switch GPT-2 at 124M width, the
    # suite's row, KFAC's stack_grams and fused_g, the MoE CLIs ----------
    t0 = time.perf_counter()
    moe_phase(estimators, models, counters, smi, dev, args.profile,
              moe_model)
    log(f"moe phase: {time.perf_counter() - t0:.1f} s ({smi})")
    torch.cuda.empty_cache()

    # -- 12. the data and sample axes: a world of one over NCCL, two gloo
    # ranks on the card, the factors CLI with --parallel ----------------
    par_by_path = parallel_phase(estimators, models, counters, smi, dev)
    count_record_launches(records, par_by_path, PAR_RECORD_PATHS)
    torch.cuda.empty_cache()

    # -- 13. the model, tensor, seq and expert axes: two gloo ranks on the
    # card, GPT-2 124M's width, the Switch GPT-2, LeNet-5 ----------------
    ma_by_path = mesh_axes_phase(estimators, models, counters, smi, dev)
    count_record_launches(records, ma_by_path, MA_RECORD_PATHS)
    log(f"peak memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    seconds = time.perf_counter() - t_start
    log(f"whole run: {seconds:.1f} s, "
        f"{'within' if seconds <= RUN_BUDGET_S else 'OVER'} its "
        f"{RUN_BUDGET_S:.0f} s budget")

    log(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def par_inputs(models, dev):
    """The gloo ranks' ResNet-18 (CIFAR stem, 10 classes, seeded weights,
    channels_last on the card), the global batch [32, 3, 32, 32], its
    injected labels [2, 32] and the eval's 64 test images in 2 batches:
    the same in every process."""
    import numpy as np
    import torch
    model = models.resnet18(num_classes=10, device=dev)
    models.load_jax_variables(model, models.seeded_variables(model, 0))
    model = model.to(memory_format=torch.channels_last)
    rng = np.random.default_rng(7)
    (x, _), = nchw_batches(rng, 1, PAR_BATCH, dev, size=32)
    labels = torch.as_tensor(rng.integers(0, 10, size=(PAR_MC, PAR_BATCH)),
                             device=dev)
    test = nchw_batches(rng, 2, PAR_TEST // 2, dev, size=32)
    return model, x, labels, [(t, y % 10) for t, y in test]


def _timed_collectives(cuda=True):
    """Wrap ``torch.distributed``'s all_reduce and all_gather with device
    synchronizes (``cuda``) and a clock; returns the dict whose ``"s"``
    sums their seconds."""
    import torch
    import torch.distributed as dist
    spent = {"s": 0.0, "calls": 0}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def wrap(fn):
        def timed(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            spent["s"] += time.perf_counter() - t0
            spent["calls"] += 1
            return out
        return timed
    dist.all_reduce = wrap(dist.all_reduce)
    dist.all_gather = wrap(dist.all_gather)
    return spent


def parallel_rank(out_dir):
    """One gloo rank of the parallel phase (``--parallel_rank``), started
    with ``torch.distributed.run``'s environment: the meshed ResNet-18
    updates (KFAC and Diagonal on ``data:2``, KFAC on ``sample:2,data:1``)
    on the global batch, their launch counts, wall and collective seconds,
    and the meshed eval. Rank 0 writes the factor states."""
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    from curvature_tpu_torch import estimators, models, parallel
    from curvature_tpu_torch.eval import eval_bnn, metrics
    from curvature_tpu_torch.ops.cuda import patch_gram as tpg
    from curvature_tpu_torch.ops.cuda import sym_gram as tsg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's deterministic algorithms, as the parent's references use
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    backend = parallel.initialize()
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    model, x, labels, test = par_inputs(models, dev)
    counters = Counters(tpg, tsg)
    spent = _timed_collectives()
    mesh = parallel.make_mesh({"data": PAR_WORLD})
    out = {"backend": backend, "rank": rank,
           "setup_s": time.perf_counter() - t0}
    # the parent's world of one runs first; its card then is free
    go = os.path.join(out_dir, "go")
    while not os.path.exists(go):
        if time.perf_counter() - t0 > 300:
            raise TimeoutError(f"no {go} after 300 s")
        time.sleep(0.05)
    t0 = time.perf_counter()

    def timed_update(est, what, warm=False):
        if warm:
            est.update(x, labels=labels)
            est.state = est.init_state()
        counters.reset()
        spent.update(s=0.0, calls=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.update(x, labels=labels)
        torch.cuda.synchronize()
        out[what] = {"wall_s": time.perf_counter() - t0,
                     "collective_s": spent["s"],
                     "collectives": spent["calls"],
                     "launches": counters.read()}
    kfac = estimators.KFAC(model).use_mesh(mesh)
    timed_update(kfac, "kfac", warm=True)
    diag = estimators.Diagonal(model).use_mesh(mesh)
    timed_update(diag, "diag")
    sd = estimators.KFAC(model).use_mesh(
        parallel.make_mesh({"sample": PAR_WORLD, "data": 1}))
    timed_update(sd, "kfac_sample")
    kfac.invert(*PAR_DAMPING)
    ens = kfac.ensemble_params(
        PAR_SAMPLES, generator=torch.Generator(device=dev).manual_seed(3))
    probs, ys, _ = eval_bnn(model, kfac, test, PAR_SAMPLES,
                            ensemble_params=ens, mesh=mesh)
    out["ece"] = float(metrics.expected_calibration_error(probs, ys)[0])
    out["nll"] = float(metrics.negative_log_likelihood(probs, ys))
    out["work_s"] = time.perf_counter() - t0
    if rank == 0:
        torch.save({"kfac": kfac.state, "diag": diag.state,
                    "kfac_sample": {n: {"g": f["g"]}
                                    for n, f in sd.state.items()}},
                   os.path.join(out_dir, "states.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _rel_close(got, want, what, rtol=PAR_RTOL, atol=PAR_ATOL):
    """Elementwise |got - want| <= atol * max|want| + rtol * |want|;
    returns max|diff| / max|want|, raising past the bar."""
    got, want = got.double(), want.double()
    scale = float(want.abs().max())
    diff = (got - want).abs()
    rel = float(diff.max()) / max(scale, 1e-30)
    bad = diff > atol * scale + rtol * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} entries past rtol "
                             f"{rtol}, atol {atol} of max (max|diff| "
                             f"{rel:.3e} of max)")
    return rel


def _hold_states(got, want, what, **bars):
    """Every leaf of two factor states within the bar; returns the worst
    max|diff| / max."""
    worst = 0.0
    for name, v in want.items():
        if isinstance(v, dict):
            worst = max(worst, _hold_states(got[name], v, f"{what} {name}",
                                            **bars))
        else:
            worst = max(worst, _rel_close(got[name], v, f"{what} {name}",
                                          **bars))
    return worst


def parallel_phase(estimators, models, counters, smi, dev):
    """The data and sample axes on the card (ROADMAP item 10a). The two
    gloo ranks start first (:func:`spawn_ranks`: their start-up overlaps
    the rest) and wait; :func:`world_of_one` runs its checks; the ranks
    then run and :func:`gloo_ranks` checks them; last the world of one's
    update rates, on a card nothing else uses. Returns the launches by
    path."""
    import os
    import shutil
    import torch
    import torch.distributed as dist
    t0 = time.perf_counter()
    root = os.path.abspath(PAR_ROOT)
    shutil.rmtree(root, ignore_errors=True)
    out_dir = os.path.join(root, "gloo")
    os.makedirs(out_dir)
    # cuDNN's deterministic algorithms: the comparisons then see only the
    # ranks' own rounding, not run-to-run algorithm choices
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    procs = spawn_ranks(out_dir)
    try:
        by_path, rates = world_of_one(estimators, models, counters, smi, dev,
                                      root)
        t_one = time.perf_counter() - t0
        open(os.path.join(out_dir, "go"), "w").close()
        by_path.update(gloo_ranks(estimators, models, counters, smi, dev,
                                  procs, out_dir))
        t_gloo = time.perf_counter() - t0 - t_one
        rates()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        torch.backends.cudnn.deterministic = was
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"parallel phase: {seconds:.1f} s (world of one {t_one:.1f} s, "
        f"gloo ranks {t_gloo:.1f} s, rates {seconds - t_one - t_gloo:.1f} "
        f"s; {smi})")
    log(f"parallel phase: {'within' if seconds <= PAR_BUDGET_S else 'OVER'}"
        f" its {PAR_BUDGET_S:.0f} s budget")
    return by_path


def spawn_ranks(out_dir):
    """Start this script twice as the two gloo ranks
    (``--parallel_rank``), with ``torch.distributed.run``'s
    environment; they run once ``<out_dir>/go`` exists."""
    import os
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(PAR_WORLD),
               LOCAL_WORLD_SIZE=str(PAR_WORLD))
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel_rank",
         out_dir],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(PAR_WORLD)]


def world_of_one(estimators, models, counters, smi, dev, root):
    """A world of one over NCCL: the ResNet-50 f32 B=16 KFAC update
    through ``use_mesh(data:1)`` against the single path on the same batch
    and labels (identity expected; 3 tiled + 1 v2 + 16 corr launches, as
    the single path's) and the ResNet-18 ``factors --parallel``
    CLI against its plain run. Returns the launches by path and the
    function that times both rates; the caller destroys the process group
    after it."""
    import os
    import numpy as np
    import torch
    from curvature_tpu_torch import parallel
    from curvature_tpu_torch.pipelines import factors
    from curvature_tpu_torch.utils.checkpoint import load_pytree
    none = counters.zero()
    by_path = {}
    backend = parallel.initialize(f"localhost:{_free_port()}", 1, 0)
    if backend != "nccl":
        raise AssertionError(f"a world of one on the card took {backend}")
    model = models.resnet50(num_classes=CLASSES, device=dev)
    models.load_jax_variables(model, models.seeded_variables(model, 0))
    model = model.to(memory_format=torch.channels_last)
    rng = np.random.default_rng(11)
    batches = [x for x, _ in nchw_batches(rng, UPDATES, BATCH, dev)]
    labels = torch.as_tensor(rng.integers(0, CLASSES, size=(1, BATCH)),
                             device=dev)
    single = estimators.KFAC(model)
    meshed = estimators.KFAC(model).use_mesh(parallel.make_mesh({"data": 1}))
    single.update(batches[0], labels=labels)
    counters.reset()
    meshed.update(batches[0], labels=labels)
    torch.cuda.synchronize()
    got = counters.read()
    want = dict(none, patch_gram_tiled=3, patch_gram_v2=1, corr_gram=R50_CORR)
    if got != counters.want(want, got):
        raise AssertionError(f"{PAR_PATHS[0]}: launches {got}, want {want}")
    by_path[PAR_PATHS[0]] = got
    worst = _hold_states(meshed.state, single.state, "world of one",
                         rtol=0.0, atol=PAR_ONE_RTOL)
    log(f"{PAR_PATHS[0]}: the update through use_mesh(data:1) over NCCL "
        f"against the single path: max|diff| {worst:.3e} of max|factor| "
        f"(bar {PAR_ONE_RTOL}); launches {json.dumps(got)}")
    def rates():
        blocks = batches[:PAR_RATE_UPDATES]
        got = {turn: best_rate(single if turn == "single" else meshed,
                               blocks, torch.Generator(device=dev)
                               .manual_seed(2), BATCH)
               for turn in ("mesh", "single")}
        log(f"{PAR_PATHS[0]}: {got['mesh']:.2f} update img/s through the "
            f"mesh, {got['single']:.2f} on the single path (in that order; "
            f"ResNet-50 f32 B={BATCH} MC=1, best of 3 blocks of "
            f"{len(blocks)} updates each; {smi})")
    files = {}
    want = dict(none, **{f"patch_gram_{r}": n * R18_UPDATES for r, n
                         in R18_ROUTES[R18_PATHS[0]].items()})
    for path, extra in ((PAR_PATHS[2], []), (PAR_PATHS[1], ["--parallel"])):
        where = os.path.join(root, path)
        _, got = run_cli(factors, R18_ARGV + [
            "--root_dir", where, "--results_dir", where, "--estimator",
            "kfac"] + extra, counters, smi, f"resnet18 factors kfac {path}")
        if got != counters.want(want, got):
            raise AssertionError(f"{path}: launches {got}, want {want}")
        by_path[path] = got
        files[path] = {n: {k: torch.from_numpy(v) for k, v in f.items()}
                       for n, f in load_pytree(os.path.join(
                           where, "factors", "resnet18_synthetic_kfac"))
                       .items()}
    worst = _hold_states(files[PAR_PATHS[1]], files[PAR_PATHS[2]],
                         "factors --parallel", rtol=0.0, atol=PAR_ONE_RTOL)
    log(f"resnet18 factors --parallel (world of one) against the plain "
        f"file: max|diff| {worst:.3e} of max|factor| (bar {PAR_ONE_RTOL})")
    return by_path, rates


def _hold_diagonal(got, one, estimators, x, labels):
    """Diagonal's state from the ranks against one float64 process on the
    same network, weights, batch and labels (the package's single path,
    its BatchNorms too in float64: :func:`float64_batch_norm`), every
    layer within PAR_DIAG64_TOL of max|factor|. Returns {layer: (the
    ranks', one f32 process's (``one``) max|diff| of max from it)}."""
    import torch
    from curvature_tpu_torch import models
    m64 = models.resnet18(num_classes=10, device=x.device)
    models.load_jax_variables(m64, models.seeded_variables(m64, 0))
    m64 = m64.double().to(memory_format=torch.channels_last)
    with float64_batch_norm():
        e64 = estimators.Diagonal(m64, dtype=torch.float64)
        e64.update(x.double(), labels=labels)
    readings = {}
    for name, want in e64.state.items():
        ranks = _rel_close(got[name], want, f"gloo diag {name} against "
                           "one float64 process", rtol=0.0,
                           atol=PAR_DIAG64_TOL)
        readings[name] = (ranks, _rel_close(one[name], want, "", rtol=0.0,
                                            atol=float("inf")))
    return readings


def _fmt(worst):
    return json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()})


@contextlib.contextmanager
def _batch_norm_forward(forward):
    """``nn.layers.BatchNorm.forward`` replaced by ``forward(self, x,
    ctx, fused)`` while inside."""
    from curvature_tpu_torch.nn import layers
    fused = layers.BatchNorm.forward
    layers.BatchNorm.forward = lambda self, x, ctx=None: forward(
        self, x, ctx, fused)
    try:
        yield
    finally:
        layers.BatchNorm.forward = fused


def plain_batch_norm(on=True):
    """While on, a capture's train-mode ``BatchNorm`` normalizes with the
    plain formula (``BatchNorm._decomposed``: the one the synced ranks
    run) instead of the fused kernel: the two differ by f32 rounding, and
    through 17 BatchNorms the G factors of the first layers by up to
    2e-5 of max (ResNet-18, B=32, CPU)."""
    def forward(self, x, ctx, fused):
        if on and self.training and ctx is not None \
                and not ctx.update_stats:
            return self._decomposed(x)
        return fused(self, x, ctx)
    return _batch_norm_forward(forward)


def float64_batch_norm():
    """While inside, ``BatchNorm`` normalizes a float64 input in float64
    (with float64 weights and statistics): the port's BatchNorm, as JAX's,
    computes in f32 whatever its input (tests/torch_float64.py patches
    both packages the same way for their float64 tests)."""
    import torch
    import torch.nn.functional as F

    def forward(self, x, ctx, fused):
        if x.dtype != torch.float64:
            return fused(self, x, ctx)
        keep = self.training and not (ctx is None or ctx.update_stats)
        return F.batch_norm(
            x, None if keep else self.running_mean,
            None if keep else self.running_var, self.weight, self.bias,
            training=self.training, momentum=self.momentum, eps=self.eps)
    return _batch_norm_forward(forward)


def _routes(kfac, acts, batch):
    """Gram-kernel launches of one KFAC update whose conv inputs have the
    shapes of ``acts`` at batch ``batch``, by JAX's routes (two a corr
    layer of one group on the card)."""
    tally = {"patch_gram_tiled": 0, "patch_gram_v2": 0, "corr_gram": 0}
    for name, meta in kfac.metas.items():
        act = acts[name]
        r = kfac.a_route(meta, (batch,) + tuple(act.shape[1:]),
                         act.element_size())
        if f"patch_gram_{r}" in tally:
            tally[f"patch_gram_{r}"] += 1
        elif r == "corr" and meta.groups == 1 and act.is_cuda:
            tally["corr_gram"] += 2
    return tally


def gloo_ranks(estimators, models, counters, smi, dev, procs, out_dir):
    """Two gloo ranks on the one card (``procs``, :func:`spawn_ranks`):
    ResNet-18 CIFAR f32 at global B=32, MC=2, injected labels. KFAC on
    ``data:2`` (BatchNorm synced) and on ``sample:2`` against one
    process's factors of the whole batch at JAX's bar, Diagonal on
    ``data:2`` against one float64 process at PAR_DIAG64_TOL; each
    rank's launches against the routes ``select_patch_gram`` gives its
    shapes (B=16 on data:2, the whole batch on sample:2); the meshed
    eval's ECE and NLL against one process's on rank 0's factors."""
    import os
    import torch
    from curvature_tpu_torch.eval import eval_bnn, metrics
    none = counters.zero()
    t0 = time.perf_counter()
    outputs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for r, (p, o) in enumerate(zip(procs, outputs)):
        for line in o.strip().splitlines()[-4:]:
            log(f"  rank {r}: {line}")
        if p.returncode != 0:
            raise AssertionError(f"gloo rank {r} exited {p.returncode}:\n"
                                 f"{o[-4000:]}")
    reports = []
    for r in range(PAR_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    t_ranks = time.perf_counter() - t0
    t0 = time.perf_counter()
    states = torch.load(os.path.join(out_dir, "states.pt"),
                        map_location=dev)

    # one process's KFAC factors of the whole batch, the same labels: with
    # the plain batch-norm formula the data ranks sync, and (sample:2 keeps
    # the whole batch on each rank, where a one-rank data group keeps the
    # fused kernel) with the fused kernel for KFAC's G on sample:2
    model, x, labels, test = par_inputs(models, dev)

    def one_kfac(plain):
        with plain_batch_norm(plain):
            kfac = estimators.KFAC(model)
            kfac.update(x, labels=labels)
        return kfac

    def one_diag():
        diag = estimators.Diagonal(model)
        diag.update(x, labels=labels)
        return diag.state
    kfac = one_kfac(True)
    fused = one_kfac(False).state
    diag = one_diag()
    refs = {"kfac": kfac.state,
            "kfac_sample": {n: {"g": f["g"]} for n, f in fused.items()}}
    worst = {what: _hold_states(states[what], ref, f"gloo {what}")
             for what, ref in refs.items()}
    worst["diag"] = _hold_states(states["diag"], diag, "", rtol=0.0,
                                 atol=float("inf"))
    diag64 = _hold_diagonal(states["diag"], diag, estimators, x, labels)
    spread = {"kfac": _hold_states(one_kfac(True).state, kfac.state,
                                   "rerun", rtol=0.0, atol=float("inf")),
              "diag": _hold_states(one_diag(), diag, "rerun", rtol=0.0,
                                   atol=float("inf"))}
    formulas = _hold_states(fused, kfac.state, "formulas", rtol=0.0,
                            atol=float("inf"))
    log(f"gloo data:2 (KFAC) and sample:2 (KFAC's G) against one process "
        f"(ResNet-18 f32 B={PAR_BATCH} MC={PAR_MC}): max|diff| of "
        f"max|factor| {_fmt(worst)} (bar rtol {PAR_RTOL}, atol {PAR_ATOL} "
        f"of max, Diagonal's read only); one process run twice "
        f"{_fmt(spread)}; its KFAC factors with the fused batch-norm kernel "
        f"against the plain formula {formulas:.3e}")
    ranks64 = {n: r for n, (r, _) in diag64.items()}
    one64 = {n: o for n, (_, o) in diag64.items()}
    top = sorted(ranks64, key=ranks64.get)[-4:]
    log(f"gloo diag data:2 against one float64 process, max|diff| of max "
        f"(bar {PAR_DIAG64_TOL}): the ranks worst {max(ranks64.values()):.3e}"
        f", one f32 process worst {max(one64.values()):.3e}; the ranks' "
        f"four worst layers "
        f"{_fmt({n: ranks64[n] for n in top})}, one f32 process there "
        f"{_fmt({n: one64[n] for n in top})}")
    acts = kfac.capture(x, labels=labels).acts
    half = PAR_BATCH // PAR_WORLD
    want = {"kfac": dict(none, **_routes(kfac, acts, half)),
            # sample:2 keeps the whole batch on each rank
            "kfac_sample": dict(none, **_routes(kfac, acts, PAR_BATCH)),
            "diag": none}
    by_path = {}
    for r, rep in enumerate(reports):
        for what, w in want.items():
            if rep[what]["launches"] != counters.want(
                    w, rep[what]["launches"]):
                raise AssertionError(f"gloo rank {r} {what}: launches "
                                     f"{rep[what]['launches']}, want {w}")
        by_path[PAR_PATHS[3 + r]] = rep["kfac"]["launches"]
        k, d = rep["kfac"], rep["diag"]
        log(f"gloo rank {r} ({rep['backend']}): kfac update "
            f"{k['wall_s'] * 1e3:.1f} ms wall, {k['collective_s'] * 1e3:.1f}"
            f" ms in {k['collectives']} collectives "
            f"({100 * k['collective_s'] / k['wall_s']:.1f}%); diag "
            f"{d['wall_s'] * 1e3:.1f} ms ({100 * d['collective_s'] / d['wall_s']:.1f}"
            f"% in collectives); kfac sample:2 "
            f"{rep['kfac_sample']['wall_s'] * 1e3:.1f} ms; launches "
            f"{json.dumps(k['launches'])} (the routes at B={half}; {smi})")
    # the meshed eval against one process's, on rank 0's factors
    for name, fac in kfac.state.items():
        for key in fac:
            fac[key] = states["kfac"][name][key]
    kfac.invert(*PAR_DAMPING)
    ens = kfac.ensemble_params(
        PAR_SAMPLES, generator=torch.Generator(device=dev).manual_seed(3))
    probs, ys, _ = eval_bnn(model, kfac, test, PAR_SAMPLES,
                            ensemble_params=ens)
    ece = float(metrics.expected_calibration_error(probs, ys)[0])
    nll = float(metrics.negative_log_likelihood(probs, ys))
    for r, rep in enumerate(reports):
        if abs(rep["ece"] - ece) > PAR_EVAL_TOL \
                or abs(rep["nll"] - nll) > PAR_EVAL_TOL:
            raise AssertionError(f"gloo rank {r} eval: ECE {rep['ece']} NLL "
                                 f"{rep['nll']}, one process ECE {ece} NLL "
                                 f"{nll}")
    log(f"gloo eval_bnn on data:2 ({PAR_TEST} images x {PAR_SAMPLES} "
        f"samples): ECE {ece:.6f} NLL {nll:.6f} on every rank and in one "
        f"process (bar {PAR_EVAL_TOL})")
    log(f"gloo part: ranks {t_ranks:.1f} s from go to exit (set-up "
        f"{', '.join(f'{r['setup_s']:.1f}' for r in reports)} s, work "
        f"{', '.join(f'{r['work_s']:.1f}' for r in reports)} s), the "
        f"references and checks {time.perf_counter() - t0:.1f} s")
    return by_path


# -- the mesh-axes phase: model, tensor, seq and expert on two gloo ranks ------
def ma_config(dev):
    """The phase's sizes, written for its ranks (a dry run on the CPU
    shrinks them)."""
    return {"device": dev.type, "depth": MA_DEPTH, "moe_depth": MA_MOE_DEPTH,
            "experts": MA_EXPERTS, "batch": MA_BATCH, "t": MA_T,
            "vocab": 50257, "dim": 768, "heads": 12,
            "lenet_batch": MA_LENET_BATCH}


def ma_model(models, kind, cfg, dtype=None):
    """(model, loss, layer filter) of a path's kind, on the CPU: the
    modules' own initialization from ``torch.manual_seed(0)``, the same
    weights in every process (numpy's seeded weights took ~2.5 s a
    GPT-2 a process)."""
    import torch
    torch.manual_seed(0)
    if kind == "lenet":
        model, loss, layers = models.lenet5(num_classes=10, device="cpu"), \
            "cross_entropy", None
    elif kind == "resnet18":
        model, loss, layers = models.resnet18(num_classes=10, device="cpu"), \
            "cross_entropy", None
    else:
        if kind == "moe":
            model = models.gpt2_moe_custom(
                cfg["vocab"], cfg["dim"], cfg["moe_depth"], cfg["heads"],
                cfg["experts"], max_len=cfg["t"], device="cpu")
        else:
            model = models.gpt2_custom(
                cfg["vocab"], cfg["dim"], cfg["depth"], cfg["heads"],
                max_len=cfg["t"], scan_blocks=kind == "scan", device="cpu")
        loss, layers = "lm", "h.*"
    return (model if dtype is None else model.to(dtype)), loss, layers


def ma_inputs(kind, cfg, dev):
    """A path's input and injected labels [1, B(, T)], numpy-seeded."""
    import numpy as np
    import torch
    rng = np.random.default_rng(11)
    if kind in ("lenet", "resnet18"):
        b = cfg["lenet_batch"]
        c, size = (1, 28) if kind == "lenet" else (3, 32)
        x = rng.standard_normal((b, c, size, size)).astype(np.float32)
        labels = rng.integers(0, 10, (1, b))
    else:
        x = rng.integers(0, cfg["vocab"], (cfg["batch"], cfg["t"]))
        labels = rng.integers(0, cfg["vocab"], (1, cfg["batch"], cfg["t"]))
    return torch.as_tensor(x, device=dev), torch.as_tensor(labels,
                                                           device=dev)


def ma_selected(metas):
    """The layers held elementwise: the first and last ``h.{i}`` layer of
    each kind (the Switch GPT-2's ``moe.fc1`` and ``moe.fc2`` of h.0
    among them); a stacked or block-free model's every layer."""
    kinds = {}
    for name in metas:
        parts = name.split(".")
        kind = ".".join(parts[2:]) if parts[0] == "h" and \
            parts[1].isdigit() else name
        kinds.setdefault(kind, []).append(name)
    return sorted({n for names in kinds.values() for n in (names[0],
                                                          names[-1])})


def ma_sums(tree):
    """{layer/key: [sum, sum of |x|, sum of x^2]} in float64."""
    out = {}
    for name, fac in tree.items():
        for key, t in fac.items():
            d = t.double()
            out[f"{name}/{key}"] = [float(d.sum()), float(d.abs().sum()),
                                    float((d * d).sum())]
    return out


def ma_noise(est, dev):
    """Standard normals of the whole model's noise shapes from
    MA_NOISE_SEED, drawn in float32 (the same numbers for the float64
    witness)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(MA_NOISE_SEED)
    return {n: torch.randn(s, generator=gen, device=dev).to(est.dtype)
            for n, s in est.noise_shapes().items()}


def ma_routes(est, model, x):
    """The kernel launches one update makes by the routes JAX's jit picks
    from the whole input's shapes (``KFAC.a_route``): the patch kernels
    under ``use_kernels``, two corr_gram launches a corr layer of one
    group on the card (a row block's too)."""
    import torch
    from curvature_tpu_torch.nn import Context
    ctx = Context(track=list(est.metas), probes=False)
    with torch.no_grad():
        model(x, ctx)
    got = {"patch_gram_tiled": 0, "patch_gram_v2": 0, "corr_gram": 0}
    for name, meta in est.metas.items():
        act = ctx.acts[name]
        route = est.a_route(meta, act.shape, act.element_size())
        if route in ("tiled", "v2") and est.use_kernels:
            got[f"patch_gram_{route}"] += 1
        elif route == "corr" and meta.groups == 1 and act.is_cuda:
            got["corr_gram"] += 2
    return got


def ma_reference(estimators, models, kind, cfg, dev, dtype=None):
    """One process's update of a path's model (``dtype`` float64: the
    witness, no kernels), its invert and draw; the selected layers'
    states and draws and every leaf's checksums and shape, on the host."""
    import torch
    model, loss, layers = ma_model(models, kind, cfg, dtype)
    model = model.to(dev)
    x, labels = ma_inputs(kind, cfg, dev)
    if dtype is not None and x.is_floating_point():
        x = x.to(dtype)
    kw = {} if dtype is None else {"dtype": dtype, "use_kernels": False}
    est = estimators.KFAC(model, loss=loss, layer_filter=layers, **kw)
    with (float64_batch_norm() if dtype == torch.float64
          else contextlib.nullcontext()):
        est.update(x, labels=labels)
    sel = ma_selected(est.metas)
    ref = {"state": {n: {k: v.cpu() for k, v in est.state[n].items()}
                     for n in sel},
           "sums": ma_sums(est.state),
           "shapes": {f"{n}/{k}": tuple(v.shape)
                      for n, fac in est.state.items()
                      for k, v in fac.items()},
           "routes": ma_routes(est, model, x)}
    est.invert(*MA_DAMPING)
    draw = est.sample(noise=ma_noise(est, dev))
    ref["draw"] = {n: draw[n].cpu() for n in sel}
    del est, model, draw
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref


def mesh_axes_rank(out_dir):
    """One gloo rank of the mesh-axes phase (``--mesh_axes_rank``), started
    with ``torch.distributed.run``'s environment; once ``<out_dir>/go``
    exists it runs each path of MA_PATHS on its mesh: one timed KFAC
    update (the first path after a warm one), its launches, collective
    seconds and peak memory, invert and one draw; it writes its blocks of
    the selected layers' states and draws, every leaf's checksums and
    block shape, and, on the model axis, the sharded checkpoint (read
    back on the mesh, bitwise)."""
    import copy
    import os
    import numpy as np
    import torch
    import torch.distributed as dist
    from curvature_tpu_torch import estimators, models, parallel
    from curvature_tpu_torch.ops.cuda import patch_gram as tpg
    from curvature_tpu_torch.ops.cuda import sym_gram as tsg
    from curvature_tpu_torch.utils import checkpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's deterministic algorithms, as the parent's references use
    torch.backends.cudnn.deterministic = True
    with open(os.path.join(out_dir, "config.json")) as f:
        cfg = json.load(f)
    cuda = cfg["device"] == "cuda"
    t0 = time.perf_counter()
    backend = parallel.initialize(device=None if cuda else "cpu")
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    rank = dist.get_rank()
    counters = Counters(tpg, tsg)
    spent = _timed_collectives(cuda)
    # the models on the CPU while the parent has the card
    built = {kind: ma_model(models, kind, cfg)
             for kind in dict.fromkeys(k for k, _ in MA_PATHS.values())}
    report = {"backend": backend, "setup_s": time.perf_counter() - t0,
              "paths": {}}
    go = os.path.join(out_dir, "go")
    while not os.path.exists(go):
        if time.perf_counter() - t0 > 300:
            raise TimeoutError(f"no {go} after 300 s")
        time.sleep(0.05)

    def sync():
        if cuda:
            torch.cuda.synchronize()
    blocks, warm = {}, True
    for path, (kind, axes) in MA_PATHS.items():
        t_path = time.perf_counter()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        mesh = parallel.make_mesh(dict(axes, data=1))
        cpu_model, loss, layers = built[kind]
        # a kind two paths share is placed anew for each mesh
        model = copy.deepcopy(cpu_model).to(dev)
        x, labels = ma_inputs(kind, cfg, dev)

        def make():
            return estimators.KFAC(model, loss=loss,
                                   layer_filter=layers).use_mesh(
                mesh, tensor_min_out=cfg.get("tensor_min_out", 128))
        if warm:
            make().update(x, labels=labels)
            warm = False
        est = make()
        counters.reset()
        spent.update(s=0.0, calls=0)
        sync()
        t_up = time.perf_counter()
        est.update(x, labels=labels)
        sync()
        wall = time.perf_counter() - t_up
        collective_s, calls = spent["s"], spent["calls"]
        launches = counters.read()
        est.invert(*MA_DAMPING)
        draw = est.sample(noise=ma_noise(est, dev))
        sel = ma_selected(est.metas)
        mine = {"state": {n: {k: v.cpu() for k, v in est.state[n].items()}
                          for n in sel},
                "draw": {n: draw[n].cpu() for n in sel},
                "sums": ma_sums(est.state),
                "shapes": {f"{n}/{k}": tuple(v.shape)
                           for n, fac in est.state.items()
                           for k, v in fac.items()}}
        if kind == "scan":
            ckpt = os.path.join(out_dir, "ckpt")
            checkpoint.save_pytree_sharded(ckpt, est.state, est.state_plan(),
                                           mesh)
            back = checkpoint.load_pytree_sharded(ckpt, mesh)
            mine["ckpt_equal"] = all(
                np.array_equal(back[n][k], v.cpu().numpy())
                for n, fac in est.state.items() for k, v in fac.items())
        blocks[path] = mine
        report["paths"][path] = {
            "update_ms": wall * 1e3, "collective_ms": collective_s * 1e3,
            "collectives": calls, "launches": launches,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if cuda else 0.0),
            "path_s": time.perf_counter() - t_path}
        del est, model, draw
        if cuda:
            torch.cuda.empty_cache()
    torch.save(blocks, os.path.join(out_dir, f"rank{rank}.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def ma_split_dim(kind, axes, key, name, ndim):
    """The dim a path's mesh splits a state leaf along (JAX's
    ``_state_leaf_spec``), or None: a stack's depth over ``model``, the
    experts over ``expert``, a column-parallel layer's G rows over
    ``tensor`` (every GPT-2 block layer's output is a multiple of 256)."""
    if "model" in axes and kind == "scan":
        return 0
    if "expert" in axes and ".moe." in name:
        return 0
    if "tensor" in axes and key == "g":
        return ndim - 2
    return None


def ma_hold(got, want, what, witness=None, **bars):
    """:func:`_rel_close` at JAX's bar; where a witness is given and the
    bar misses (f32 sums split over the seq ranks, or a column-parallel G
    row block, another GEMM shape than the whole Gram), the float64
    witness at PAR_DIAG64_TOL of max, or at twice one f32 process's own
    max|diff| from it where that is larger (PR 16's rule: the bar about
    twice one f32 process's reading; a draw passes f32 rounding through
    the inverse roots). Returns (max|diff| / max against ``want``, whether
    the witness held it)."""
    try:
        return _rel_close(got, want, what, **bars), False
    except AssertionError:
        if witness is None:
            raise
        w = witness.double()
        one = float((want.double() - w).abs().max() / w.abs().max())
        _rel_close(got, witness, f"{what} vs float64 (one f32 process "
                   f"{one:.3e} of max from it)", rtol=0.0,
                   atol=max(PAR_DIAG64_TOL, 2 * one))
        diff = (got.double() - want.double()).abs().max()
        return float(diff / want.double().abs().max()), True


def ma_check(path, kind, axes, ranks, ref, wit, dev):
    """Hold each rank's blocks of ``path`` to one process's (``ref``; the
    float64 ``wit`` for seq and tensor), comparing on ``dev``; returns
    (worst state, worst draw, worst checksum readings, holdings, holdings
    by the witness)."""
    worst = [0.0, 0.0, 0.0]
    n_split, held, by_witness = 0, 0, 0
    for r, blocks in enumerate(ranks):
        mine = blocks[path]
        for leaf, shape in ref["shapes"].items():
            name, key = leaf.rsplit("/", 1)
            dim = ma_split_dim(kind, axes, key, name, len(shape))
            want = list(shape)
            if dim is not None:
                want[dim] //= MA_WORLD
                n_split += 1
            if tuple(mine["shapes"][leaf]) != tuple(want):
                raise AssertionError(f"{path} rank {r}: {leaf} block "
                                     f"{mine['shapes'][leaf]}, want {want} "
                                     f"of {shape}")
        for part, i, bars in (("state", 0, {}),
                              ("draw", 1, {"rtol": 1e-4, "atol": 1e-5})):
            for name, got in mine[part].items():
                leaves = got.items() if isinstance(got, dict) else [(None,
                                                                     got)]
                for key, t in leaves:
                    whole = ref[part][name] if key is None \
                        else ref[part][name][key]
                    w64 = None if wit is None else (
                        wit[part][name] if key is None
                        else wit[part][name][key])
                    for d in range(t.ndim):
                        if t.shape[d] != whole.shape[d]:
                            per = t.shape[d]
                            whole = whole.narrow(d, r * per, per)
                            if w64 is not None:
                                w64 = w64.narrow(d, r * per, per)
                    rel, w = ma_hold(
                        t.to(dev), whole.to(dev),
                        f"{path} rank {r} {part} {name} {key}",
                        None if w64 is None else w64.to(dev), **bars)
                    worst[i] = max(worst[i], rel)
                    held, by_witness = held + 1, by_witness + w
    for leaf, want in ref["sums"].items():
        name, key = leaf.rsplit("/", 1)
        split = ma_split_dim(kind, axes, key, name,
                             len(ref["shapes"][leaf])) is not None
        got = ([sum(b[path]["sums"][leaf][j] for b in ranks)
                for j in range(3)] if split else ranks[0][path]["sums"][leaf])
        rel = max(abs(got[0] - want[0]) / max(want[1], 1e-30),
                  abs(got[2] - want[2]) / max(want[2], 1e-30))
        if rel > 4 * PAR_RTOL:
            w = wit["sums"][leaf] if wit is not None else None
            rel64 = None if w is None else max(
                abs(got[0] - w[0]) / max(w[1], 1e-30),
                abs(got[2] - w[2]) / max(w[2], 1e-30))
            if rel64 is None or rel64 > 4 * PAR_DIAG64_TOL:
                raise AssertionError(f"{path}: {leaf} checksums {got} vs "
                                     f"{want} ({rel:.3e})")
            by_witness += 1
        worst[2] = max(worst[2], rel)
    if {"model", "tensor", "expert"} & set(axes) and n_split == 0:
        raise AssertionError(f"{path}: no state leaf is split")
    return worst + [held + len(ref["sums"]), by_witness]


def mesh_axes_phase(estimators, models, counters, smi, dev, cfg=None):
    """The model, tensor, seq and expert axes on the card (ROADMAP item
    10b): two gloo ranks (:func:`mesh_axes_rank`) start first and wait;
    this process computes one process's update, invert and draw of each
    path's model (and a float64 witness of the GPT-2 and LeNet-5 models,
    for the seq and tensor paths) with the same
    seeded weights, labels and noise, keeps what it holds on the host and
    frees the card; the ranks then run and each rank's blocks, checksums
    and launches are held to it. Returns the ranks' launches by path."""
    import os
    import shutil
    import torch
    from curvature_tpu_torch.utils.checkpoint import load_pytree_sharded
    cfg = cfg or ma_config(dev)
    t0 = time.perf_counter()
    out_dir = os.path.abspath(MA_ROOT)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(MA_WORLD),
               LOCAL_WORLD_SIZE=str(MA_WORLD))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--mesh_axes_rank",
         out_dir], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(MA_WORLD)]
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        refs, wits = {}, {}
        for kind, axes in MA_PATHS.values():
            if kind not in refs:
                refs[kind] = ma_reference(estimators, models, kind, cfg, dev)
            if {"seq", "tensor"} & set(axes) and kind not in wits:
                wits[kind] = ma_reference(estimators, models, kind, cfg, dev,
                                          torch.float64)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t_ref = time.perf_counter() - t0
        log(f"mesh axes: one-process references and float64 witnesses "
            f"{t_ref:.1f} s, on the host; the card freed for the ranks")
        open(os.path.join(out_dir, "go"), "w").close()
        outputs = [p.communicate(timeout=600)[0].decode() for p in procs]
        for r, (p, o) in enumerate(zip(procs, outputs)):
            if p.returncode != 0:
                raise AssertionError(f"mesh-axes rank {r} exited "
                                     f"{p.returncode}:\n{o[-4000:]}")
        ranks, reports = [], []
        for r in range(MA_WORLD):
            ranks.append(torch.load(os.path.join(out_dir, f"rank{r}.pt")))
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                reports.append(json.load(f))
    finally:
        torch.backends.cudnn.deterministic = was
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    t_ranks = time.perf_counter() - t0 - t_ref
    log(f"mesh axes: the ranks' start-up and their models built on the "
        f"CPU took {reports[0]['setup_s']:.1f} s, beside the references")
    log(f"mesh axes: GPT-2 124M width (dim {cfg['dim']}, {cfg['heads']} "
        f"heads, vocabulary {cfg['vocab']}) at B={cfg['batch']}, "
        f"T={cfg['t']}, depth cut from 12 to {cfg['depth']} blocks (the "
        f"Switch GPT-2, E={cfg['experts']}, to {cfg['moe_depth']}); LeNet-5 "
        f"(28x28) and ResNet-18 CIFAR (32x32) at B={cfg['lenet_batch']}; "
        "KFAC f32, injected labels, two gloo ranks "
        f"({reports[0]['backend']}) on the card")
    by_path = {}
    none = counters.zero()
    for path, (kind, axes) in MA_PATHS.items():
        wit = wits.get(kind) if {"seq", "tensor"} & set(axes) else None
        state, draw, sums, held, by_witness = ma_check(
            path, kind, axes, ranks, refs[kind], wit, dev)
        want = dict(none, **refs[kind]["routes"])
        for r, rep in enumerate(reports):
            got = rep["paths"][path]
            if got["launches"] != counters.want(want, got["launches"]):
                raise AssertionError(f"{path} rank {r}: launches "
                                     f"{got['launches']}, want {want}")
            by_path[f"{path}_rank{r}"] = got["launches"]
            share = got["collective_ms"] / max(got["update_ms"], 1e-9)
            log(f"  rank {r}: {path} took {got['path_s']:.1f} s (model, "
                "update, invert, draw, writes)")
            log(f"{path} rank {r}: update {got['update_ms']:.1f} ms, "
                f"collectives {got['collective_ms']:.1f} ms "
                f"({100 * share:.1f}%) in {got['collectives']}, peak "
                f"{got['peak_gib']:.2f} GiB, Gram launches "
                f"{got['launches']['patch_gram_tiled']} tiled + "
                f"{got['launches']['patch_gram_v2']} v2 ({smi})")
        if kind == "scan":
            if not all(b[path]["ckpt_equal"] for b in ranks):
                raise AssertionError(f"{path}: a rank's checkpoint blocks "
                                     "read back changed")
            whole = load_pytree_sharded(os.path.join(out_dir, "ckpt"))
            for r, b in enumerate(ranks):
                for name, fac in b[path]["state"].items():
                    for key, t in fac.items():
                        per = t.shape[0]
                        if not torch.equal(torch.from_numpy(
                                whole[name][key][r * per:(r + 1) * per]), t):
                            raise AssertionError(
                                f"{path}: checkpoint {name}/{key} differs "
                                f"from rank {r}'s block")
        log(f"{path}: held to one process (state {state:.3e}, draw "
            f"{draw:.3e} of max, checksums {sums:.3e}; {by_witness} of "
            f"{held} holdings by the float64 witness"
            + (", checkpoint round trip bitwise" if kind == "scan" else "")
            + ")")
    seconds = time.perf_counter() - t0
    log(f"mesh-axes phase: {seconds:.1f} s (references {t_ref:.1f} s, "
        f"ranks {t_ranks:.1f} s, checks "
        f"{seconds - t_ref - t_ranks:.1f} s; {smi}), "
        f"{'within' if seconds <= MA_BUDGET_S else 'OVER'} its "
        f"{MA_BUDGET_S:.0f} s budget")
    return by_path


def count_record_launches(records, by_path, record_paths):
    """Each record's launches on a phase's paths: a record named in
    ``record_paths`` counts its counter on its paths there, every other
    record 0; raises unless every launch of a phase stands under exactly
    one record."""
    counted = {}
    for rec in records:
        # the batched kernel's records count its wrapper on every path
        mine = (tuple(by_path) if rec["counter"] == "sym_gram_batched"
                else record_paths.get(rec["name"], ()))
        rec["launches_by_path"].update(
            {p: got[rec["counter"]] if p in mine else 0
             for p, got in by_path.items()})
        rec["launches"] = sum(rec["launches_by_path"].values())
        for p in mine:
            key = (p, rec["counter"])
            counted[key] = counted.get(key, 0) + by_path[p][rec["counter"]]
    for p, got in by_path.items():
        for counter in ("patch_gram_tiled", "patch_gram_v2", "corr_gram"):
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
