#!/bin/bash
# The serving launcher over NCCL ranks on the cards of one host:
# deepseek-coder-33b at full width and depth (33,111,773,184 parameters,
# 66.2 GB in bfloat16, an 8.3 GB KV cache at 8 slots x 4096) through the
# split decode step at (data 1, model 4), which one card cannot hold, and
# qwen2.5-14B at full width and depth at (4, 1), the reference's plan, and
# on one card (the same tokens: compare tokens_digest). 8 requests of 32
# prompt and 32 new tokens in 8 slots. Each run's log goes to
# OUT/serve_<arch>_<ranks>_<want_model>.log (OUT: the first argument,
# artifacts/serve_ranks by default); the JSON line of each run is printed
# (tok_per_s, p50_decode_step_s, peak_memory_bytes_per_rank). The arguments
# after OUT, each "ARCH RANKS WANT_MODEL", choose other runs, e.g.
# "zamba2_7b 4 4" "zamba2_7b 1 1" (zamba2-7b at full depth at (1, 4), where
# every rank reads and writes the whole Mamba2 state each step, and on one
# card).
#
#   bash scripts/serve_ranks_check.sh [OUT ["ARCH RANKS WANT_MODEL" ...]]   # needs 4 cards
set -u
cd "$(dirname "$0")/.."
out=${1:-artifacts/serve_ranks}
runs=("deepseek_coder_33b 4 4" "qwen2_5_14b 4 1" "qwen2_5_14b 1 1")
if [ $# -gt 1 ]; then runs=("${@:2}"); fi
export PYTHONPATH=src
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())'
mkdir -p "$out"
for run in "${runs[@]}"; do
  set -- $run
  log=$out/serve_$1_$2_$3.log
  torchrun --nproc-per-node "$2" --master-port $((29400 + RANDOM % 500)) \
    -m repro_torch.launch.serve --arch "$1" --want-model "$3" --slots 8 --requests 8 \
    --prompt-len 32 --gen-len 32 --max-len 4096 --device cuda > "$log" 2>&1
  echo "$1 ranks=$2 want_model=$3 rc=$? $(grep '^{' "$log" | tail -1)"
  grep -E "Error|error" "$log" | tail -3
done
