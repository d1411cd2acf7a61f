#!/bin/bash
# The trainer over NCCL ranks on the cards of one host, against one card:
# each model at full width and depth, 3 steps of batch 8 x 128, at
# --want-model 1, 2 and 4 over 4 ranks, and on one card. The models are the
# arguments after OUT (default: h2o-danube-1.8b, granite-moe-3b-a800m,
# zamba2-7b, xlstm-350m). Each run's log goes to
# OUT/nccl_<arch>_<ranks>_<want_model>.log (OUT: the first argument,
# artifacts/train_ranks by default); the JSON line of each run and its step
# lines are printed. RANKS and WANT_MODELS narrow the runs (default "1 4"
# and "1 2 4"); CKPT_EVERY=N checkpoints every N steps into a temporary
# directory (removed after each run), each run's checkpoint lines printed.
#
#   bash scripts/train_ranks_check.sh [OUT [ARCH...]]    # needs 4 cards
#   RANKS=4 WANT_MODELS=2 CKPT_EVERY=3 bash scripts/train_ranks_check.sh OUT zamba2_7b
set -u
cd "$(dirname "$0")/.."
out=${1:-artifacts/train_ranks}
shift || true
archs=${*:-h2o_danube_1_8b granite_moe_3b_a800m zamba2_7b xlstm_350m}
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())'
mkdir -p "$out"
for arch in $archs; do
  for n in ${RANKS:-1 4}; do
    for wm in ${WANT_MODELS:-1 2 4}; do
      if [ "$n" = 1 ] && [ "$wm" != 1 ]; then continue; fi
      log=$out/nccl_${arch}_${n}_${wm}.log
      ckpt=()
      if [ -n "${CKPT_EVERY:-}" ]; then
        dir=$(mktemp -d)
        ckpt=(--ckpt-dir "$dir" --ckpt-every "$CKPT_EVERY")
      fi
      torchrun --nproc-per-node "$n" --master-port $((29400 + RANDOM % 500)) \
        -m repro_torch.launch.train --arch "$arch" --steps 3 --batch 8 --seq 128 \
        --device cuda --want-model "$wm" --log-every 1 "${ckpt[@]}" > "$log" 2>&1
      echo "$arch ranks=$n want_model=$wm rc=$? $(grep '^{' "$log" | tail -1)"
      grep -E "^step|Error" "$log" | tail -4
      if [ -n "${CKPT_EVERY:-}" ]; then
        du -sb "$dir"/step_* 2>/dev/null
        rm -rf "$dir"
      fi
    done
  done
done
