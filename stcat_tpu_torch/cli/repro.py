"""Reproduce a released result in one command: evaluate a checkpoint and
print its metrics against the reference model-zoo targets.

    python -m stcat_tpu_torch.cli.repro --weights vidstg_res448.pth --data-dir /data/vidstg \\
        --tokenizer-dir /assets/roberta-base \\
        --config-file experiments/VidSTG/e2e_STCAT_R101_VidSTG.yaml [KEY VALUE ...]

The evaluation is cli.test's, run in-process with the same arguments. The
report (JSON on stdout) gives the metrics in points, the model-zoo targets
of the dataset and resolution (the reference README's table; 416 and 448
only) and each metric's distance to its target; ``--require-within P``
exits 1 when a metric lands more than P points below its target.
``--synthetic`` runs on the synthetic dataset instead.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import add_common_args, load_config

# (dataset, resolution) -> {metric: published value}, m_vIoU in points
MODEL_ZOO = {
    ("VidSTG", 416): {"declar_viou": 32.94, "inter_viou": 27.87},
    ("VidSTG", 448): {"declar_viou": 33.14, "inter_viou": 28.22},
    ("HC-STVG", 416): {"viou": 34.93},
    ("HC-STVG", 448): {"viou": 35.09},
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="STCAT reference reproduction (PyTorch)")
    p.add_argument("--weights", required=True,
                   help="reference .pth checkpoint (or a converted checkpoint directory)")
    p.add_argument("--data-dir", required=True, help="dataset root (annotations, videos/frames)")
    p.add_argument("--tokenizer-dir", default="",
                   help="local roberta-base directory (vocab.json, merges.txt)")
    add_common_args(p)
    p.add_argument("--require-within", type=float, default=None, metavar="PTS",
                   help="exit 1 if any metric is more than PTS below its target")
    p.add_argument("--synthetic", action="store_true", help="use the synthetic dataset")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def run(args) -> dict:
    from .test import main as test_main

    overrides = ["DATA_DIR", args.data_dir, "MODEL.WEIGHT", args.weights]
    if args.tokenizer_dir:
        overrides += ["MODEL.TEXT_MODEL.LOCAL_PATH", args.tokenizer_dir]
    overrides += list(args.opts or [])
    cfg = load_config(args.config_file, overrides)
    argv = ["--device", args.device] + (["--config-file", args.config_file]
                                         if args.config_file else [])
    res = test_main(argv + (["--synthetic"] if args.synthetic else []) + overrides)
    if res is None:
        raise RuntimeError("evaluation returned no metrics (not the main process?)")

    dataset, resolution = cfg.DATASET.NAME, int(cfg.INPUT.RESOLUTION)
    targets = MODEL_ZOO.get((dataset, resolution))
    report = {
        "dataset": dataset,
        "resolution": resolution,
        "weights": args.weights,
        "metrics": {k: round(100.0 * v, 2) for k, v in res.items()},
        "targets": targets or {},
        "deltas": {},
    }
    if targets is None:
        report["note"] = (f"no model-zoo target for {dataset}@{resolution} (the reference "
                          "publishes 416 and 448 only)")
    else:
        report["deltas"] = {k: round(100.0 * res[k] - t, 2) for k, t in targets.items()
                            if k in res}
    return report


def main(argv=None):
    args = parse_args(argv)
    report = run(args)
    print(json.dumps(report, indent=2))
    if args.require_within is not None and report["targets"]:
        worst = min(report["deltas"].values(), default=0.0)
        if worst < -args.require_within:
            print(f"FAIL: worst metric delta {worst:+.2f} pts is below the --require-within "
                  f"{args.require_within} gate", file=sys.stderr)
            raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
