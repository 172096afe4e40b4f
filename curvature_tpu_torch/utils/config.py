"""Configuration: one dataclass over the reference's flag surface.

Port of ``curvature_tpu/utils/config.py``: the same ``Config`` fields and
defaults, so one command line parses to the same configuration in both
packages, with ``parse_args``/``setup`` as the CLI front end.

``--platform`` keeps its name: ``''`` runs on the CUDA device (and raises
without one), ``cpu`` on the CPU. ``setup`` keeps TF32 off, so f32 matmuls
and convolutions run in strict f32 as the parity rules require. Every
flag of the JAX package is ported and none is ignored; ``--plot`` writes
the figures as PDF (``pipelines/plot.py``). ``--parallel``/``--mesh``
start the process group of a ``torch.distributed.run`` launch in
``setup`` (``parallel.initialize``).
"""
import argparse
import dataclasses
import os
from dataclasses import dataclass

import torch

from curvature_tpu_torch.utils.device import resolve_device


@dataclass
class Config:
    # paths
    root_dir: str = "."
    results_dir: str = "."
    data_dir: str = ""              # dataset location; defaults under root_dir
    prefix: str = ""
    suffix: str = ""
    # compute
    platform: str = ""              # '' = the CUDA device; 'cpu' forces CPU
    precision: str = "default"      # 'default' | 'float32' strict f32
                                    # | 'bfloat16' bf16 forwards
    workers: int = 0
    parallel: bool = False          # every rank on one data axis
    mesh: str = ""                  # 'data:N[,model:M,...]' over the ranks
    # experiment
    model: str = "lenet5"
    data: str = "mnist"
    batch_size: int = 32
    epochs: int = 1
    lr: float = 1e-3
    momentum: float = 0.9
    l2: float = 0.0
    optimizer: str = "random"       # hyperopt / training optimizer
    opt_damping: float = 1e-2       # KFAC-optimizer damping (training)
    objective: str = "cost"         # hyperopt objective
    # Laplace approximation
    estimator: str = "kfac"         # diag | block | kfac | efb | inf |
                                    # swag | subspace
    samples: int = 30               # posterior weight samples
    sample_chunk: int = 0           # max resident sampled param sets (0=all)
    predictive: str = "sampled"     # BNN predictive
    mc_samples: int = 10            # Fisher MC label samples per batch
    token_subsample: float = 1.0    # KFAC: spatial token fraction of the
                                    # conv A-factor Grams
    scan_chunk: int = 8             # batches per update_batches call
    calls: int = 50                 # hyperopt calls
    boundaries: bool = False
    exp_id: str = "-1"
    layer: bool = False             # layer-wise damping
    layers: str = ""                # subnetwork Laplace: 'last' or comma-
                                    # separated fnmatch patterns
    pre_scale: int = 1
    augment: bool = False
    norm: float = -1.0
    scale: float = -1.0
    epsilon: float = 0.0
    rank: int = 100
    swag: bool = False
    swag_rank: int = 20
    bn_update: bool = False
    g_block_size: int = 1024        # KFAC: block size of the blocked G of
                                    # dense layers past max_factor_dim
                                    # (vocab heads; 0 = hard error)
    qkv_split: bool = False         # KFAC: per q/k/v chunk attention G
    head_split: bool = False        # KFAC: per-head attention factors
    scan_blocks: bool = False       # GPT-2, ViT: depth-stacked blocks
                                    # (nn/scan.py)
    seq_len: int = 64               # GPT-2: context length of --data tokens
    vocab: int = 0                  # GPT-2: vocabulary of the model and of
                                    # --data tokens (0 = 256)
    fidelity: int = 0
    spectrum: int = 0
    # toggles
    plot: bool = False
    no_results: bool = False
    stats: bool = False
    calibration: bool = False
    ood: bool = False
    fgsm: bool = False
    loss1d: bool = False
    loss2d: bool = False
    ecdf: bool = False
    entropy: bool = False
    summary: bool = False
    eigvals: bool = False
    hyper: bool = False
    networks: bool = False
    landscapes: bool = False
    verbose: bool = False
    seed: int = 42

    def __post_init__(self):
        if not self.data_dir:
            self.data_dir = os.path.join(self.root_dir, "datasets")


def parse_args(argv=None, **overrides) -> Config:
    """Build a Config from CLI arguments (flag names match the reference's)."""
    parser = argparse.ArgumentParser()
    for f in dataclasses.fields(Config):
        name = f"--{f.name}"
        default = overrides.get(f.name, f.default)
        if f.type == bool or isinstance(default, bool):
            parser.add_argument(name, action="store_true", default=default)
        else:
            parser.add_argument(name, type=type(default), default=default)
    ns = parser.parse_args(argv)
    return Config(**vars(ns))



def check_ported(cfg: Config):
    """Every flag of the JAX package is ported; what is left to check is
    the platform: ``--platform`` is ``''``, ``cuda``, ``gpu`` or ``cpu``."""
    if cfg.platform not in ("", "cpu", "cuda", "gpu"):
        raise ValueError(f"--platform {cfg.platform!r}: the port runs on "
                         "'cpu' or the CUDA device ('' / 'cuda' / 'gpu')")


def device(cfg: Config) -> torch.device:
    """The configuration's device: the CPU for ``--platform cpu``, else the
    current CUDA device, raising when there is none."""
    return resolve_device("cpu" if cfg.platform == "cpu" else None)


def setup(argv=None, **overrides) -> Config:
    """Parse flags, check that each one is ported and that its device
    exists, keep TF32 off, seed the RNGs (reference utils.setup,
    utils.py:333-430)."""
    cfg = parse_args(argv, **overrides)
    check_ported(cfg)
    if cfg.parallel or cfg.mesh:
        # bad axes raise here; the process group starts (and picks this
        # rank's GPU) before any model is built
        from curvature_tpu_torch.parallel import initialize
        from curvature_tpu_torch.parallel.mesh import check_size, cli_axes
        axes = cli_axes(cfg)
        initialize(device="cpu" if cfg.platform == "cpu" else None)
        if axes is not None:
            check_size(axes)
    device(cfg)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from curvature_tpu_torch.utils.monitor import seed_all_rng
    seed_all_rng(cfg.seed)
    return cfg
