"""The readings behind tests/test_torch_bf16.py's constants (PERF.md §6).

    JAX_PLATFORMS=cpu python scripts/torch_bf16_readings.py [--seeds 0,1,2,3]

For every case of tests/test_torch_bf16.py and each seed: e_jax, e_port and
d per tensor and the largest max(e_port, d) / e_jax per case; for the train
step also the median of that ratio over the gradients, the largest ratios
with the packages' fp32 gap beside them, and the zero-gradient tensors
(count, largest fp32 norm, largest bf16 norm over JAX's); then the two
planted faults on each stress case, as the largest ratio over its tensors.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import test_torch_bf16 as tb  # noqa: E402

CASES = {
    "preprocess": tb.case_preprocess,
    "roberta layer": tb.case_roberta_layer,
    "text encoder": tb.case_roberta_encoder,
    "resnet xla": lambda s: tb.case_resnet("xla", s),
    "resnet pallas": lambda s: tb.case_resnet("pallas", s),
    "resnet folded": lambda s: tb.case_resnet("folded", s),
    "encoder layer": lambda s: tb.case_encoder_layer("pallas", s),
    "encoder xla": lambda s: tb.case_encoder("xla", s),
    "encoder pallas": lambda s: tb.case_encoder("pallas", s),
    "spatial decoder layer": lambda s: tb.case_spatial_decoder_layer("pallas", s),
    "time decoder layer": lambda s: tb.case_time_decoder_layer("pallas", s),
    "heads": tb.case_heads,
    "stcatnet": lambda s: tb.case_stcatnet(s)[0],
    "postprocess": lambda s: tb.case_postprocess(*tb.case_stcatnet(s))[0],
    "do_eval": lambda s: tb.case_do_eval(pathlib.Path(tempfile.mkdtemp()), s)[0],
}
STRESS = {
    "text encoder, embeddings offset by 8": lambda s: tb.case_text_encoder_stress(s),
    "peaked self-attention": lambda s: tb.case_time_decoder_layer("pallas", s, heads=1, tied=True,
                                                                  scale=0.2),
}


def ratio(e_jax, e_port, d) -> float:
    if not max(e_port, d):
        return 0.0
    return max(e_port, d) / e_jax if e_jax else float("inf")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    seeds = [int(s) for s in ap.parse_args().seeds.split(",")]
    for name, case in CASES.items():
        worst = (0.0, "")
        for seed in seeds:
            for tensor, r in tb.readings(case(seed)).items():
                print(f"{name} seed {seed} {tensor}: e_jax {r[0]:.3e} e_port {r[1]:.3e} "
                      f"d {r[2]:.3e}")
                if r[0] and ratio(*r) > worst[0]:
                    worst = (ratio(*r), f"{tensor} seed {seed}")
        print(f"== {name}: largest max(e_port, d) / e_jax {worst[0]:.2f} ({worst[1]})")
    for seed in seeds:
        cases, gap = tb.case_train_step(seed)
        reads = tb.readings(cases)
        noise = [n for n, g in gap.items() if g > tb.NOISE_GAP]
        grads = {n: r for n, r in reads.items() if n.startswith("grad.") and n not in noise}
        losses = {n: r for n, r in reads.items() if n.startswith("loss.")}
        size = [np.linalg.norm(tb._np(cases[n][3]))
                / max(np.linalg.norm(tb._np(j)) for j in cases[n][1:3]) for n in noise]
        print(f"== train step seed {seed}: gradient median ratio "
              f"{np.median([ratio(*r) for r in grads.values() if r[0]]):.2f}; "
              f"{len(noise)} zero gradients (fp32 norm up to "
              f"{max(np.linalg.norm(tb._np(cases[n][0])) for n in noise):.1e}, bf16 size up to "
              f"{max(size):.1f}x JAX's); largest other fp32 gap "
              f"{max(g for n, g in gap.items() if n not in noise):.1e}")
        for n, r in sorted(losses.items(), key=lambda kv: -max(kv[1][1:]))[:3]:
            print(f"   {n}: e_jax {r[0]:.2e}, e_port {r[1]:.2e}, d {r[2]:.2e}")
        for n, r in sorted(grads.items(), key=lambda kv: -ratio(*kv[1]))[:6]:
            print(f"   {n}: ratio {ratio(*r):.2f}, e_jax {r[0]:.2e}, e_port {r[1]:.2e}, "
                  f"d {r[2]:.2e}, fp32 gap {gap.get(n, 0.0):.1e}")
    for name, case in STRESS.items():
        for seed in seeds:
            worst = {}
            for fault in (None, "bf16_logits", "bf16_ln_stats"):
                if fault is None:
                    reads = tb.readings(case(seed))
                else:
                    with tb.planted(fault):
                        reads = tb.readings(case(seed))
                worst[fault] = max(ratio(*r) for r in reads.values())
            print(f"== stress {name} seed {seed}: clean {worst[None]:.2f}, bf16 logits "
                  f"{worst['bf16_logits']:.2f}, bf16 LayerNorm statistics "
                  f"{worst['bf16_ln_stats']:.2f} (x e_jax)")


if __name__ == "__main__":
    main()
