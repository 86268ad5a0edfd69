"""Command-line entry points: train, test, convert, infer, serve, repro,
precompile. Each ``main(argv=None)`` takes its arguments as a list (the
process's own when None), so one entry point can run another in-process, and
runs on ``cuda`` unless ``--device`` names another device. train, test and
precompile also run as the ranks of a ``torchrun`` launch (``add_dist_args``,
``start``): each rank on ``cuda:{LOCAL_RANK}``, the mesh from cfg.TPU.

    torchrun --nproc-per-node 4 -m stcat_tpu_torch.cli.train --dist-backend nccl \
        --config-file experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml TPU.MODEL_PARALLEL 2 ...
"""


def add_common_args(parser) -> None:
    """--config-file and --device; each CLI adds the trailing KEY VALUE
    overrides (``opts``) last."""
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def load_config(config_file: str = "", opts=None):
    """The default config, merged with a YAML recipe and KEY VALUE overrides."""
    from ..config import default_config, merge_from_file, merge_from_list

    cfg = default_config()
    if config_file:
        cfg = merge_from_file(cfg, config_file)
    if opts:
        cfg = merge_from_list(cfg, list(opts))
    return cfg


def dataset_builder(synthetic: bool):
    """builder(cfg, split) -> dataset: the synthetic twin, written under
    DATA_DIR on first use (``--synthetic``), or the benchmark's cache."""
    if synthetic:
        from ..data.synthetic import make_synthetic_dataset

        return make_synthetic_dataset
    from ..data.datasets import build_dataset

    return build_dataset


def add_dist_args(parser) -> None:
    parser.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                        help="process-group backend under torchrun (default: nccl on cuda, "
                             "gloo on the CPU; gloo for several ranks on one card)")


def start(args):
    """This rank's device, after joining the torchrun process group when the
    environment describes one (``core.dist.init_from_env``)."""
    from ..core.dist import init_from_env
    from ..ops.misc import resolve_device

    return resolve_device(init_from_env(args.dist_backend, args.device))
