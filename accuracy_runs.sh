#!/bin/bash
# The accuracy loop's long recipes on one card, as PERF.md reports them
# (about 45 minutes on an H100):  bash accuracy_runs.sh
# `bash accuracy_runs.sh spread` runs only phase 11a's recipe RUNS times
# (default 4) side by side, logs in chiprun_out/spread/.
# smoke_train_eval (2000 steps), the tiny SAM (TINY_SAM_STEPS, 4500 by
# default, its JAX tool's default) and the descriptor (2500) side by side, then train_flagship (2000 steps, batch 8, its AR curve),
# then ism_accuracy_eval with both segmentors and the flagship PEM.  Logs,
# a timeline and the records go to chiprun_out/long/; checkpoints to
# .ckpt_* (ignored by git).
cd "$(dirname "$0")"
O=chiprun_out/${1:-long}; mkdir -p $O
export OMP_NUM_THREADS=2
stamp() { echo "[$(date +%s)] $*" | tee -a $O/timeline.log; }
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee $O/smi.txt
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' | tee -a $O/smi.txt
M=sam6d_tpu_torch.tools
# Build the kernels once, before the runs start side by side.
python -c 'import chip_smoke as c; from sam6d_tpu_torch.ops import _kernels; _kernels.build_all(c.all_kernels())' > $O/build.log 2>&1
if [ "$1" = spread ]; then
  # chip_smoke.py's phase 11a recipe (SMOKE_STEPS steps, same seeds) ${RUNS:-4}
  # times side by side: training on the card is not bit-reproducible, so
  # this is the spread that its bound on the held-out median must clear.
  S=$(python -c 'import chip_smoke as c; print(c.SMOKE_STEPS)')
  for r in $(seq 1 ${RUNS:-4}); do
    timeout 900 python -u -m $M.smoke_train_eval --steps $S --objects 128 --eval 16 --eval_every 250 > $O/spread_$r.log 2>&1 &
  done
  wait
  grep -H "rot err" $O/spread_*.log | grep -v train-obj
  exit 0
fi
stamp start
(timeout 1800 python -u -m $M.smoke_train_eval --steps 2000 --objects 128 --eval 16 --eval_every 100 --ckpt_dir .ckpt_smoke > $O/smoke.log 2>&1; stamp "smoke rc $?";
 timeout 600 python -u -m $M.e2e_synthetic_ar --ckpt_dir .ckpt_smoke --frames 12 --out build/e2e_ar > $O/e2e_smoke.log 2>&1; stamp "e2e rc $?") &
P1=$!
(timeout 2400 python -u -m $M.train_tiny_sam --steps ${TINY_SAM_STEPS:-4500} --ckpt .ckpt_tiny_sam > $O/tiny_sam.log 2>&1; stamp "tiny_sam rc $?"; cp .ckpt_tiny_sam/tiny_sam_recall.json $O/ 2>/dev/null) &
P3=$!
timeout 900 python -u -m $M.train_ism_descriptor --steps 2500 --ckpt_dir .ckpt_ism_desc > $O/desc.log 2>&1
stamp "desc rc $?"
cp .ckpt_ism_desc/train_meta.json $O/desc_meta.json 2>/dev/null
stamp "flagship start"
timeout 1800 python -u -m $M.train_flagship --steps 2000 --batch_size 8 --workers 4 --ckpt_dir .ckpt_flagship --ckpt_every 500 --eval_curve 500,1000,1500,2000 --eval_frames 12 > $O/flagship.log 2>&1
stamp "flagship rc $?"
cp .ckpt_flagship/flagship_ar.json .ckpt_flagship/metrics.jsonl $O/ 2>/dev/null
wait $P3
stamp "ism start"
timeout 700 python -u -m $M.ism_accuracy_eval --desc_ckpt .ckpt_ism_desc --pem_ckpt .ckpt_flagship --pem_config flagship --held_out 2 --frames 50 --bank_objects 16 --segmentor depth_cc,tiny_sam --sam_ckpt .ckpt_tiny_sam --out build/ism_acc > $O/ism.log 2>&1
stamp "ism rc $?"
cp build/ism_acc/ism_acc.json build/ism_acc/selection_diag_*.json $O/ 2>/dev/null
wait $P1
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee -a $O/smi.txt
stamp end
