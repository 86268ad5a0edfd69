#!/usr/bin/env bash
# Long training run of the PyTorch port (stcat_tpu_torch) on one card: 2400
# iterations of the default recipe through the production input chain (JPEG
# corpus -> loader -> yuv420 ingest -> on-card preprocess -> step), with a
# checkpoint every 300 iterations, EMA validation every 800, a SIGTERM at
# iteration >= 1200 and a resume that continues to the end. The port's
# counterpart of scripts/longrun_r4.sh, with the same corpus and options.
#
#   bash scripts/torch_longrun.sh                  # phases A, B and C
#   DEVICE=cpu OUT=... DATA=... STOP_AT=N bash scripts/torch_longrun.sh KEY VALUE ...
#
# Trailing KEY VALUE pairs override the options below (a rehearsal at tiny
# widths); DEVICE (default cuda) goes to --device. Checkpoints hold the
# weights, the EMA and the AdamW moments: ~3.3 GB each at the default
# widths, nine of them in OUT. The metrics are summarised by
# scripts/longrun_summary.py into ARTIFACT (default artifacts/longrun_torch),
# beside the validations, the final evaluation, the log and the card's name
# and power limit.
set -euo pipefail
cd "$(dirname "$0")/.."

DATA=${DATA:-.cache/longrun_torch_corpus}
OUT=${OUT:-out/longrun_torch}
ARTIFACT=${ARTIFACT:-artifacts/longrun_torch}
DEVICE=${DEVICE:-cuda}
STOP_AT=${STOP_AT:-1200}

python - "$DATA" <<'PY'
import sys
from stcat_tpu_torch.data.synthetic import write_synthetic_cache, materialize_frame_corpus
data = sys.argv[1]
for split, n in (("train", 12), ("test", 4)):
    write_synthetic_cache(data, "VidSTG", split, n_items=n, n_frames=96, width=320, height=240)
    materialize_frame_corpus(data, "VidSTG", split)
print("corpus ready")
PY

# MAX_EPOCH 200 x 12 iterations per epoch = 2400 steps; the LR schedule sees
# the whole horizon in both phases, so the resume continues the same schedule.
OPTS=(
  DATA_DIR "$DATA" OUTPUT_DIR "$OUT"
  INPUT.RESOLUTION 416
  SOLVER.MAX_EPOCH 200 SOLVER.CHECKPOINT_PERIOD 300
  SOLVER.TO_VAL true SOLVER.VAL_PERIOD 800 SOLVER.PRE_VAL false
  TPU.INGEST_LAYOUT yuv420 DATALOADER.NUM_WORKERS 2
  INPUT.AUG_SCALE false INPUT.AUG_CROP false
  "$@"
)
TRAIN=(python -m stcat_tpu_torch.cli.train --synthetic --device "$DEVICE" "${OPTS[@]}")

if [ ! -f "$OUT/checkpoints/last_checkpoint" ]; then
  echo "=== phase A: train from scratch, SIGTERM at iteration >= $STOP_AT ==="
  "${TRAIN[@]}" &
  PID=$!
  python - "$OUT" "$PID" "$STOP_AT" <<'PY'
import json, os, signal, sys, time
out, pid, stop_at = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
path = os.path.join(out, "metrics.jsonl")
while True:
    time.sleep(5)
    try:
        os.kill(pid, 0)
    except OSError:
        sys.exit("trainer exited before the preemption point")
    it = 0
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    it = json.loads(line).get("step", it)
                except ValueError:
                    pass  # torn tail write
    if it >= stop_at:
        print(f"sending SIGTERM at iteration {it}")
        os.kill(pid, signal.SIGTERM)
        break
PY
  wait "$PID" || true
  echo "=== phase A done (preempted) ==="
fi

echo "=== phase B: resume to the end ==="
"${TRAIN[@]}"

# the loop validates every VAL_PERIOD but at the last iteration (as the JAX
# loop does); the final EMA weights are evaluated by the test entry point
echo "=== phase C: evaluate the final EMA weights ==="
python -m stcat_tpu_torch.cli.test --synthetic --device "$DEVICE" "${OPTS[@]}" \
  MODEL.WEIGHT "$OUT" OUTPUT_DIR "$OUT/final_test"

python scripts/longrun_summary.py "$OUT" "$ARTIFACT"
cp "$OUT/validation.jsonl" "$OUT/final_test/test_results.json" "$OUT/log.txt" "$ARTIFACT/"
if command -v nvidia-smi >/dev/null; then
  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader > "$ARTIFACT/device.txt"
fi
echo "wall: ${SECONDS} s"
