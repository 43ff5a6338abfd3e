#!/bin/bash
# Run the whole card suite (tests/test_torch_cuda.py, marker cuda) of the
# checkout at CHECKOUT on one card in PROCESSES pytest processes at once (4
# by default, each cut at SECONDS): the kernel library and the host geometry
# library are built first, the collected test ids are split round-robin, and
# each process writes OUTDIR/TAG_shard<i>.txt. Prints the card, nvcc's and
# PyTorch's versions, each process's exit code and its summary line.
#
#   bash tools/card_tests_sharded.sh CHECKOUT TAG OUTDIR [PROCESSES] [SECONDS]
set -u
mkdir -p "$3"
root=$(cd "$1" && pwd); tag=$2; out=$(cd "$3" && pwd); shards=${4:-4}; limit=${5:-2100}
cd "$root"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
"${CUDA_HOME:-/usr/local/cuda}"/bin/nvcc --version | tail -2
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
t0=$(date +%s)
python -c "from endosurf_tpu_torch.kernels import build; build.load_library()
from endosurf_tpu_torch.native import build as nb; nb.build_library()"
echo "build $(( $(date +%s) - t0 )) s"
ids=$(mktemp)
python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q -p no:cacheprovider \
    --collect-only 2>/dev/null | grep '::' > "$ids"
echo "$(wc -l < "$ids") tests"
for s in $(seq 0 $((shards - 1))); do
  (awk -v s="$s" -v n="$shards" 'NR % n == s' "$ids" > "$ids.$s"
   timeout "$limit" python -m pytest -m cuda --noconftest -q -p no:cacheprovider -rP \
       $(cat "$ids.$s") > "$out/${tag}_shard$s.txt" 2>&1
   echo "shard $s rc $?") &
done
wait
echo "card suite $tag in $(( $(date +%s) - t0 )) s"
for s in $(seq 0 $((shards - 1))); do
  grep -hE "^(FAILED|ERROR)|[0-9]+ (passed|failed)" "$out/${tag}_shard$s.txt" | tail -8
done
rm -f "$ids" "$ids".*
