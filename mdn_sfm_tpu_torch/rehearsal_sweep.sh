#!/bin/bash
# How often phase 1 of the rehearsal falls into the photometric loss's
# degenerate optimum, over seeds and --lr1 values, in the world of
# chip_smoke.py's REHEARSAL_ARGV (64x128, B=4, 300 steps, the bright patch
# moving 6 px a frame). Each run is `synthetic_e2e --modes ""` (phase 1 and
# the calibration) with --verbose; a run that falls into the optimum exits 1
# with "degenerate optimum" on stderr. Then, on the card, phase 9's check
# (chip_smoke.rehearsal_run) once at each rate in FULL_LRS.
#
#   { for s in $(seq 0 19); do echo "a_s$s $s 1e-4"; done; } |
#       bash mdn_sfm_tpu_torch/rehearsal_sweep.sh log/p1
#
# Reads lines "tag seed lr1" on stdin. Environment: DEVICE (cuda), DTYPE
# (bfloat16 on the card, float32 on the CPU), JOBS (7 runs at a time),
# THREADS (1 intra-op thread a run), FULL_LRS ("1.5e-4 1e-4 5e-5"; empty or
# DEVICE=cpu skips the check). Writes OUT_DIR/<tag>.log and prints, per arm
# (the tag's text before its first "_"), the runs, the diverged runs and
# each run's last group.
set -u
cd "$(dirname "$0")/.."
out=${1:?usage: rehearsal_sweep.sh OUT_DIR < "tag seed lr1" lines}
export OUT=$out DEVICE=${DEVICE:-cuda} THREADS=${THREADS:-1}
if [ "$DEVICE" = cpu ]; then export DTYPE=${DTYPE:-float32}; else export DTYPE=${DTYPE:-bfloat16}; fi
mkdir -p "$out"
[ "$DEVICE" = cpu ] || nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
[ "$DEVICE" = cpu ] || python -c 'from mdn_sfm_tpu_torch.ops import _build; print(_build.build_all())'
scratch=$(mktemp -d)
export SCRATCH=$scratch
run() {
  OMP_NUM_THREADS=$THREADS python -m mdn_sfm_tpu_torch.synthetic_e2e --height 64 --width 128 --batch_size 4 \
    --eval_batch 8 --steps1 300 --k_steps 50 --bright_world --obj_shift 6 --obj_size 16 --modes "" \
    --seed "$2" --lr1 "$3" --device "$DEVICE" --compute_dtype "$DTYPE" --verbose --log_dir "$SCRATCH/$1" \
    > "$OUT/$1.log" 2>&1
  echo "rc=$?" >> "$OUT/$1.log"
}
export -f run
t0=$(date +%s)
xargs -P "${JOBS:-7}" -L 1 bash -c 'run "$@"' _
echo "loop_seconds=$(( $(date +%s) - t0 ))"
for arm in $(ls "$out" | grep -v '^full_' | sed 's/_.*//' | sort -u); do
  logs=$(ls "$out"/"${arm}"_*.log)
  echo "arm=$arm runs=$(echo "$logs" | wc -l) diverged=$(grep -l "degenerate optimum" $logs | wc -l)"
done
for f in "$out"/*.log; do
  case $(basename "$f") in full_*) continue ;; esac
  echo "$(basename "$f") $(grep 'phase1 group' "$f" | tail -1) $(tail -1 "$f")"
done
[ "$DEVICE" = cpu ] && { rm -rf "$scratch"; exit 0; }
full() {
  python - "$1" > "$OUT/full_$1.log" 2>&1 <<'PY'
import shutil, sys, tempfile, time
lr = sys.argv[1]
sys.argv = ["chip_smoke.py"]
import chip_smoke as C
C.REHEARSAL_ARGV = list(C.REHEARSAL_ARGV)
C.REHEARSAL_ARGV[C.REHEARSAL_ARGV.index("--lr1") + 1] = lr
t0 = time.perf_counter()
base = tempfile.mkdtemp(prefix="mdn_e2e_")
try:
    C.rehearsal_run(base, "card")
finally:
    shutil.rmtree(base, ignore_errors=True)
print("rehearsal_seconds", time.perf_counter() - t0)
PY
  echo "rc=$?" >> "$OUT/full_$1.log"
}
t0=$(date +%s)
for lr in ${FULL_LRS-1.5e-4 1e-4 5e-5}; do full "$lr" & done
wait
echo "full_seconds=$(( $(date +%s) - t0 ))"
for f in "$out"/full_*.log; do
  [ -f "$f" ] || continue
  echo "$f $(tail -2 "$f" | tr '\n' ' ')"
  grep -o '"checks": {[^}]*}' "$f"
done
rm -rf "$scratch"
