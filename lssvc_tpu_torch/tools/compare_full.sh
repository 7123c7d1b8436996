#!/usr/bin/env bash
# Full RD comparison at one intra period (the twin of the root
# compare_full_IP12.sh and compare_full_IP32.sh): per ratio, the FL BD-rate
# of the port's results against the SHM-12.4 and VTM-21.2 anchors, through
# `python -m lssvc_tpu_torch.compare_rd`.
#
# Usage: RESULTS_DIR=output/IP32 ANCHORS_DIR=/path/to/json_results \
#        lssvc_tpu_torch/tools/compare_full.sh 32
#
# RESULTS_DIR defaults to output/IP<period>, PLOT_DIR to
# output/plots_IP<period>; ANCHORS_DIR, which has no default here, is the
# reference's json_results directory, {hevc,VTM}/IP<period>/<ratio>_FL.json.
# Run it from the repository root.
set -euo pipefail

if [ $# -ne 1 ]; then
  echo "usage: $0 INTRA_PERIOD (12 or 32)" >&2
  exit 2
fi
IP=$1
RESULTS_DIR=${RESULTS_DIR:-output/IP$IP}
ANCHORS_DIR=${ANCHORS_DIR:-}
PLOT_DIR=${PLOT_DIR:-output/plots_IP$IP}
if [ ! -d "$ANCHORS_DIR" ]; then
  echo "ANCHORS_DIR '$ANCHORS_DIR' is not a directory: set it to the" \
       "reference's json_results ({hevc,VTM}/IP$IP/<ratio>_FL.json)" >&2
  exit 1
fi
mkdir -p "$PLOT_DIR"

for ratio in x2 x1_5 x3 x4; do
  echo "=============================== ratio $ratio ==============================="
  python -m lssvc_tpu_torch.compare_rd \
    --results \
      LSSVC="$RESULTS_DIR/${ratio}_FL.json" \
      SHM="$ANCHORS_DIR/hevc/IP$IP/${ratio}_FL.json" \
      VTM="$ANCHORS_DIR/VTM/IP$IP/${ratio}_FL.json" \
    --anchor SHM \
    --plot "$PLOT_DIR/${ratio}_FL.png"
done
