#!/bin/bash
# The port's quality studies at the JAX tools' protocols, on one CUDA card:
# the protocols of PARITY.md's numbers (tools/tpu_queue_aa.sh for the field
# and camera studies; PARITY.md for the segmenter, the inpainter and the
# vanilla orbit), each study a program of its own, all started together
# after one build of the fused kernels. The study_field tri arm and
# study_vanilla run twice, for the spread of two runs. Logs and results go
# under the directory given (default outputs/parity_torch); the last lines of
# each log are printed. A second argument, a space-separated list of
# field_a field_b camopt camopt_2layer segmenter inpaint vanilla_a vanilla_b,
# runs only those.
#
#   bash tools/parity_studies_torch.sh [out_dir [runs]]
set -u
cd "$(dirname "$0")/.."
O=${1:-outputs/parity_torch}
RUNS=" ${2:-field_a field_b camopt camopt_2layer segmenter inpaint vanilla_a vanilla_b} "
mkdir -p "$O"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$O/card.txt"
python3 -c "import time; from nerf_kbs_tpu_torch.ops import _kernels; t = time.time(); _kernels.build(); print('nvcc s', time.time() - t)"
export OMP_NUM_THREADS=1
TRI="max_res=64 base_res=4 hidden_dim=128 num_layers=3 num_proposal_samples_per_ray=[128,48] fourier_basis=tri fourier_anneal_steps=1500 stop_grad_sampling=true"
declare -A CMD
CMD[field_a]="tools/study_field_torch.py --field fourier --steps 1800 --eval-every 300 --name tri_ab $TRI"
CMD[field_b]=${CMD[field_a]}
# the frozen arm at the tool's own point (the registry's, a 3-layer base
# MLP), and beside it at num_layers=2: the JAX tool that wrote
# outputs/camopt_study/frozen.json set no num_layers, and its config's
# default was 2 (git show ad19577:tools/study_camera_opt.py, make_cfg)
CMD[camopt]="tools/study_camera_opt_torch.py --steps 3000 --eval-every 500 --frozen-steps 3000 --arms frozen --out $O/frozen.json fourier_anneal_steps=1000"
CMD[camopt_2layer]="${CMD[camopt]/frozen.json/frozen_2layer.json} num_layers=2"
CMD[segmenter]="tools/train_segmenter_torch.py --scenes 24 --eval-scenes 6 --steps 2500 --out $O/segmenter"
CMD[inpaint]="tools/validate_inpaint_torch.py --steps 800 --out $O/inpaint"
CMD[vanilla_a]="tools/study_vanilla_torch.py --steps 3000 --eval-every 3000"
CMD[vanilla_b]=${CMD[vanilla_a]}
start=$(date +%s)
declare -A PID
for run in field_a field_b camopt camopt_2layer segmenter inpaint vanilla_a vanilla_b; do
    [[ "$RUNS" == *" $run "* ]] || continue
    # shellcheck disable=SC2086
    python3 ${CMD[$run]} > "$O/$run.log" 2>&1 &
    PID[$run]=$!
done
rc=0
for run in "${!PID[@]}"; do
    wait "${PID[$run]}"; r=$?
    echo "$run exit $r at $(( $(date +%s) - start )) s"
    [ "$r" -ne 0 ] && rc=$r
done
rm -rf "$O/inpaint/images" "$O/inpaint/masks"
for f in "$O"/*.log; do echo "== $f"; tail -n 4 "$f" | cut -c1-1500; done
exit $rc
