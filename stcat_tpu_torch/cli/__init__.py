"""Command-line entry points: train, test, convert, infer, serve, repro,
precompile. Each ``main(argv=None)`` takes its arguments as a list (the
process's own when None), so one entry point can run another in-process, and
runs on ``cuda`` unless ``--device`` names another device."""


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
