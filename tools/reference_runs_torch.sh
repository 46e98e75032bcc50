#!/bin/bash
# The JAX package's reference operating point on the port, on one CUDA card:
# the 30,000-step runs on the 40-frame 375x1242 synthetic street scene
# (PARITY.md:501-530) behind the JAX package's headline quality numbers.
# Each protocol is its JAX queue script's argv letter for letter, through the
# port's launchers:
#   ilf050            tools/tpu_queue_q.sh:6-12 (FLAG) and :17-19 (the run)
#   sem30k-flagship2  tools/tpu_queue_w.sh:5-12 (FLAG) and :13-17 (the run)
# What differs: --trainer.output_dir (<out_dir>/<protocol>-s<seed>), the
# seed (each protocol at 42, the JAX runs' default, and at 43), and
# --trainer.steps_per_save 5000 (JAX: 30000), which leaves a checkpoint every
# 5,000 steps. A run whose directory holds a checkpoint resumes from it
# (resume_argv below), so a run cut by a time limit goes on where it stopped
# when the script is started again on the same directory; a finished run is
# skipped.
#
# The runs go one after another, after one build of the fused kernels. The
# scene is written first when outputs/kitti_syn is absent. Per run, the
# launcher's log and the card's memory in use (nvidia-smi, MiB, every 2 s)
# go beside its metrics.jsonl; the last lines of each log are printed.
#
#   bash tools/reference_runs_torch.sh [out_dir [runs]]
#   bash tools/reference_runs_torch.sh --argv [out_dir [runs]]  # each run's command; runs nothing
#   bash tools/reference_runs_torch.sh --resume <run_dir> <steps>  # resume_argv
#
# out_dir defaults to outputs/reference_torch; runs is a space-separated list
# of ilf050-s42 ilf050-s43 sem30k-flagship2-s42 sem30k-flagship2-s43 (default
# all four). A suffix -d<n> (ilf050-s42-d1) also sets --datamanager.seed n,
# which varies the batches (the JAX runs drew at the default, 0).
set -u
cd "$(dirname "$0")/.."

# The extra argv that takes the run in directory $1 on to step $2 from its
# last checkpoint, after cutting its metrics.jsonl back to that checkpoint's
# step (the resumed run logs the rest again): --trainer.load_dir, and the
# steps left as --trainer.max_num_iterations (the CLI trains that many more);
# nothing without a checkpoint; "done" when the run has its eval_all_* line
# at step $2, and --eval-only when only that line is missing.
resume_argv() {
    local last
    last=$(ls "$1"/ckpt_*.pt 2>/dev/null | sort | tail -n 1)
    [ -n "$last" ] || return 0
    python3 - "$1" "$((10#$(basename "$last" .pt | cut -d_ -f2)))" "$2" <<'PY'
import json, sys
from pathlib import Path
run_dir, k, steps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
path = Path(run_dir) / "metrics.jsonl"
logged = [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()] \
    if path.exists() else []
kept = [m for m in logged if m["step"] <= k]
path.write_text("".join(json.dumps(m) + "\n" for m in kept))
if k < steps:
    print(f"--trainer.load_dir {run_dir} --trainer.max_num_iterations {steps - k}")
elif any("eval_all_num_images" in m and m["step"] == k for m in kept):
    print("done")
else:
    print(f"--eval-only true --trainer.load_dir {run_dir}")
PY
}

PRINT=0
if [ "${1:-}" = "--argv" ]; then PRINT=1; shift; fi
if [ "${1:-}" = "--resume" ]; then resume_argv "$2" "$3"; exit; fi
O=${1:-outputs/reference_torch}
RUNS=${2:-ilf050-s42 ilf050-s43 sem30k-flagship2-s42 sem30k-flagship2-s43}
STEPS=30000

# tools/tpu_queue_q.sh:6-12
FLAG_Q="--dataparser.data_dir outputs/kitti_syn --dataparser.first_frame 0 --dataparser.last_frame 40 \
 --dataparser.image_height 375 --dataparser.image_width 1242 --dataparser.train_split_fraction 0.9 \
 --dataparser.use_depth true --dataparser.depth_unit_scale_factor 1.0 \
 --datamanager.train_num_rays_per_batch 16384 \
 --model.max_res 256 --model.fourier_anneal_steps 5000 --model.appearance_embedding_dim 0 \
 --trainer.steps_per_dispatch 50 --trainer.steps_per_eval_image 5000 \
 --trainer.steps_per_eval_batch 5000 --trainer.steps_per_eval_all_images 30000 \
 --trainer.steps_per_save 30000 --trainer.log_every 1000 --trainer.max_num_iterations 30000"
# tools/tpu_queue_w.sh:5-12
FLAG_W="--dataparser.data_dir outputs/kitti_syn --dataparser.first_frame 0 --dataparser.last_frame 40 \
 --dataparser.image_height 375 --dataparser.image_width 1242 --dataparser.train_split_fraction 0.9 \
 --dataparser.use_depth true --dataparser.depth_unit_scale_factor 1.0 \
 --dataparser.semantics_dir outputs/kitti_syn/sem --dataparser.mask_dir outputs/kitti_syn/mask \
 --datamanager.train_num_rays_per_batch 16384 \
 --model.fourier_anneal_steps 5000 --model.appearance_embedding_dim 0 \
 --trainer.steps_per_dispatch 50 --trainer.steps_per_eval_image 5000 \
 --trainer.steps_per_eval_batch 5000 --trainer.steps_per_eval_all_images 30000 \
 --trainer.steps_per_save 30000 --trainer.log_every 1000 --trainer.max_num_iterations 30000"

# the launcher, method and argv of run $1 (<protocol>-s<seed>, or
# <protocol>-s<seed>-d<batch seed>, which adds --datamanager.seed), on one
# line; the JAX run's own --trainer.output_dir stands, and the later one wins
run_argv() {
    local protocol=${1%-s*} seed=${1##*-s}
    local tail="--trainer.output_dir $O/$1 --trainer.seed ${seed%-d*} --trainer.steps_per_save 5000"
    [ "${seed%-d*}" = "$seed" ] || tail="$tail --datamanager.seed ${seed#*-d}"
    case $protocol in
        # tools/tpu_queue_q.sh:17-19
        ilf050) echo train_nerfacto_torch.py nerfacto-tpu $FLAG_Q \
            --model.interlevel_ray_fraction 0.5 \
            --trainer.output_dir outputs/r3ilf --trainer.experiment_name ilf050 $tail ;;
        # tools/tpu_queue_w.sh:13-17
        sem30k-flagship2) echo train_torch.py semantic-nerfw $FLAG_W \
            --model.field_type fourier --model.fourier_basis tri --model.max_res 256 --model.base_res 4 \
            --model.hidden_dim 128 --model.num_proposal_samples_per_ray "(96,32)" \
            --model.stop_grad_sampling true --model.interlevel_ray_fraction 0.5 \
            --trainer.output_dir outputs/r3sem --trainer.experiment_name sem30k-flagship2 $tail ;;
        *) echo "unknown run $1" >&2; return 1 ;;
    esac
}

if [ "$PRINT" = 1 ]; then
    for run in $RUNS; do run_argv "$run" || exit 1; done
    exit 0
fi

# The host sampler's draw depends on the OpenMP thread count: each thread
# seeds its own generator with its thread id and takes a static share of the
# batch (nerf_kbs_tpu_torch/native/ray_sampler.cpp). The JAX runs drew on a
# one-core host (tools/tune_decoder.py:16-17), so at one thread the port
# trains on their batches: sem30k-flagship2-s42 then logs JAX's depth_loss at
# steps 1k to 5k within 0.4% (PERF.md), against 46% off at the default count
# of an 8-core host.
export OMP_NUM_THREADS=1
mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/card.txt"
[ -d outputs/kitti_syn ] || python3 tools/regen_data_torch.py || exit 1
python3 -c "import time; from nerf_kbs_tpu_torch.ops import _kernels; t = time.time(); _kernels.build(); print('nvcc s', time.time() - t)"

rc=0
for run in $RUNS; do
    words=$(run_argv "$run") || exit 1
    # shellcheck disable=SC2086
    set -- $words
    launcher=$1 method=$2
    dir="$O/$run/${run%-s*}/$method"  # the experiment is named after the protocol
    mkdir -p "$dir"
    resume=$(resume_argv "$dir" "$STEPS")
    [ "$resume" = done ] && { echo "$run: done"; continue; }
    [ -n "$resume" ] && echo "$run: $resume"
    nvidia-smi --query-gpu=memory.used --format=csv,noheader,nounits -lms 2000 >> "$dir/memory_mib.txt" &
    smi=$!
    start=$(date +%s)
    # shellcheck disable=SC2086
    python3 $words $resume >> "$dir/train.log" 2>&1
    r=$?
    kill "$smi" 2>/dev/null; wait "$smi" 2>/dev/null
    echo "$run ($launcher) exit $r after $(( $(date +%s) - start )) s," \
         "card memory in use at most $(sort -n "$dir/memory_mib.txt" | tail -n 1) MiB"
    [ "$r" -ne 0 ] && rc=$r
    tail -n 3 "$dir/train.log" | cut -c1-1500
done
exit $rc
