#!/bin/bash
# The port's full training run on one GPU, held against the JAX package's
# 100-epoch R2R-EI run (experiments/queue_r4b.sh:50-56; its validation
# trajectory and 100-image eval are experiments/evidence/
# dl_g2_r2r_evalint_validation.csv and eval_dl_g2_r2r_evalint_ep100.log);
# with FULL_RUN_TASK=sr, its SR x2 R2R-EI run instead
# (experiments/queue_r3q.sh:54-56; its epoch losses and 100-image evals are
# experiments/evidence/sr2_r2r_training.csv, eval_sr2_r2r_ep100.log and
# eval_sr2_upsample.log):
#   1. the dead-leaves Div2K stand-in, experiments/make_dead_leaves_div2k.py
#      at its defaults (800 train / 100 val at 384x512, seed 0), through
#      tools_torch/make_dead_leaves_div2k.py (its palette photo committed
#      there: the GPU machine has no matplotlib);
#   2. python -m sei_tpu_torch.cli.train with the recipe's flags, in f32 at
#      --scan_steps 1 (validation.csv every 10 epochs over 16 val images);
#   3. python -m sei_tpu_torch.cli.test of weights.pt on the 100 val images,
#      the Identity row (SR: the bicubic Upsample row), and the same weights
#      in a bf16 model (get_model(dtype=torch.bfloat16) through
#      evaluate_pairs, beside the f32 model on the same pairs: the bf16
#      serving check);
#   4. the trajectory and the scores beside the JAX run's (compare.txt; SR:
#      the epoch losses side by side, as the JAX SR run kept no validation).
# With FULL_RUN_TASK=baselines, no training: after step 1, cli.test of the
# training-free baselines at deblurring Gaussian_R2 noise 5, InverseFilter,
# TV and DeepImagePrior (its default 4000 iterations) on val images 0-4 and
# BM3D on 0-1, as the JAX package scored them (experiments/evidence/
# eval_{invfilter,tv,dip}_5imgs.log, eval_bm3d_2imgs.log), then compare.txt.
# Every time is printed beside the card's name and power limit.
#
#   bash full_run_torch.sh                  # on one GPU, about 40 minutes
#   FULL_RUN_TASK=sr bash full_run_torch.sh # SR x2, about 40 minutes
#   FULL_RUN_TASK=baselines bash full_run_torch.sh  # evidence_torch/baselines/
#
# The data and the run (checkpoints, weights.pt) go under $FULL_RUN_DIR
# (default _full_run/, gitignored); the small text outputs (training.csv,
# validation.csv, the logs, the eval summaries, times.txt, compare.txt)
# under $FULL_RUN_EVIDENCE (default evidence_torch/, evidence_torch/sr2/ for
# SR).  $FULL_RUN_ARGS adds flags to every command line and
# $FULL_RUN_EPOCHS sets the epochs (a CPU rehearsal: FULL_RUN_ARGS="--device
# cpu --SwinIR__embed_dim 12 --SwinIR__depths 2 --SwinIR__num_heads 2
# --SwinIR__window_size 4" FULL_RUN_EPOCHS=1); $FULL_RUN_WORKERS caps the
# generator's processes.
set -euo pipefail
cd "$(dirname "$0")"
RUN_ROOT=${FULL_RUN_DIR:-_full_run}
TASK=${FULL_RUN_TASK:-deblurring}
EPOCHS=${FULL_RUN_EPOCHS:-100}
read -r -a EXTRA <<< "${FULL_RUN_ARGS:-}"
if [ "$TASK" = sr ]; then
  EV=${FULL_RUN_EVIDENCE:-evidence_torch/sr2}
  RUN=$RUN_ROOT/sr2_r2r_evalint
  G2=(--task sr --sr_factor 2 --noise_level 5)
  TAG=sr2_r2r_ep$EPOCHS BASELINE=Upsample BASE_TAG=sr2_upsample
elif [ "$TASK" = deblurring ]; then
  EV=${FULL_RUN_EVIDENCE:-evidence_torch}
  RUN=$RUN_ROOT/dl_g2_r2r_evalint
  G2=(--task deblurring --kernel Gaussian_R2 --noise_level 5)
  TAG=r2r_ep$EPOCHS BASELINE=Identity BASE_TAG=identity
elif [ "$TASK" = baselines ]; then
  EV=${FULL_RUN_EVIDENCE:-evidence_torch/baselines}
  G2=(--task deblurring --kernel Gaussian_R2 --noise_level 5)
else
  echo "FULL_RUN_TASK: deblurring, sr or baselines, got $TASK" >&2
  exit 2
fi
mkdir -p "$EV" "$RUN_ROOT"
DATA=$(cd "$RUN_ROOT" && pwd)/datasets
DD=(--dataset div2k --GroundTruthDataset__datasets_dir "$DATA")
: > "$EV/times.txt"

smi() { nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null || echo "no nvidia-smi"; }
now() { date +%s.%N; }
stamp() {  # stamp <label> <start>: seconds since start, beside the card
  echo "$1: $(python -c "print(f'{$(now) - $2:.1f}')") s; $(smi)" | tee -a "$EV/times.txt"
}
echo "card: $(smi)"

t0=$(now)
python tools_torch/make_dead_leaves_div2k.py --out "$DATA" \
  ${FULL_RUN_WORKERS:+--workers "$FULL_RUN_WORKERS"} | tail -1
stamp "dead-leaves Div2K stand-in (800 + 100 PNGs) generated" "$t0"

if [ "$TASK" = baselines ]; then
  for spec in "InverseFilter 0,1,2,3,4 invfilter_5imgs" "TV 0,1,2,3,4 tv_5imgs" \
              "DeepImagePrior 0,1,2,3,4 dip_5imgs" "BM3D 0,1 bm3d_2imgs"; do
    read -r kind idx tag <<< "$spec"
    t0=$(now)
    python -m sei_tpu_torch.cli.test "${G2[@]}" "${DD[@]}" --model_kind "$kind" \
      --indices "$idx" --print_all_metrics "${EXTRA[@]}" 2>&1 | tee "$EV/eval_$tag.log"
    stamp "cli.test $kind, val images $idx (reads and model build included)" "$t0"
    smi >> "$EV/eval_$tag.log"
  done
  python - "$EV" <<'EOF' | tee "$EV/compare.txt"
# The port's baseline scores beside the JAX package's, to the full runs' 0.5 dB / 0.01.
import re, sys
ev, jax_ev = sys.argv[1], "experiments/evidence"
def summary(path):
    text = open(path).read()
    return {k: float(re.search(rf"^{k}: ([-0-9.]+)$", text, re.M).group(1)) for k in ("PSNR", "SSIM")}
for tag in ("invfilter_5imgs", "tv_5imgs", "dip_5imgs", "bm3d_2imgs"):
    got, want = summary(f"{ev}/eval_{tag}.log"), summary(f"{jax_ev}/eval_{tag}.log")
    ok = abs(got["PSNR"] - want["PSNR"]) <= 0.5 and abs(got["SSIM"] - want["SSIM"]) <= 0.01
    print(f"{tag}: port {got['PSNR']:.2f} / {got['SSIM']:.4f}, JAX {want['PSNR']:.2f} / "
          f"{want['SSIM']:.4f}; target within 0.5 dB and 0.01: {'met' if ok else 'MISSED'}")
EOF
  exit 0
fi

t0=$(now)
python -m sei_tpu_torch.cli.train "${G2[@]}" --method proposed \
  --ProposedLoss__sure_alternative r2r "${DD[@]}" --epochs "$EPOCHS" \
  --eval_interval 10 --eval_count 16 --scan_steps 1 --out_dir "$RUN" "${EXTRA[@]}" \
  2>&1 | tee "$EV/train.log"
stamp "cli.train, $EPOCHS epochs (data read, warm-up, capture, validations included)" "$t0"
cp "$RUN/training.csv" "$RUN/validation.csv" "$EV/"

for kind in weights "$BASELINE"; do
  t0=$(now)
  if [ "$kind" = weights ]; then flags=(--weights "$RUN/weights.pt"); tag=$TAG
  else flags=(--model_kind "$kind"); tag=$BASE_TAG; fi
  python -m sei_tpu_torch.cli.test "${G2[@]}" "${DD[@]}" "${flags[@]}" "${EXTRA[@]}" \
    2>&1 | tail -8 | tee "$EV/eval_$tag.log"
  stamp "cli.test $tag, 100 val images (reads and model build included)" "$t0"
  smi >> "$EV/eval_$tag.log"
done

t0=$(now)
python - "${G2[@]}" "${DD[@]}" --weights "$RUN/weights.pt" "${EXTRA[@]}" <<'EOF' \
  | tee "$EV/eval_bf16_serving.log"
# The same weights in an f32 and a bf16 model, on the pairs cli.test scores.
import sys, time
import numpy as np
import torch
from sei_tpu_torch.cli.train import ground_truth, setup, swinir_overrides
from sei_tpu_torch.config import DefaultArgParser, add_test_args
from sei_tpu_torch.data import image_seed
from sei_tpu_torch.evaluate import degraded_pair, evaluate_pairs
from sei_tpu_torch.models import get_model
from sei_tpu_torch.train.checkpoint import get_weights

parser = DefaultArgParser()
add_test_args(parser)
args = parser.parse_args(sys.argv[1:])
device, physics = setup(args)
gt = ground_truth(args, "val")
pairs = [degraded_pair(physics, torch.as_tensor(gt[i], device=device),
                       image_seed(0, gt.unique_id(i))) for i in range(len(gt))]
scores = {}
for label, dtype in (("f32", None), ("bf16", torch.bfloat16)):
    model = get_model(task=args.task, sr_factor=args.sr_factor, device=device,
                      swinir_overrides=swinir_overrides(args), dtype=dtype)
    model.load_weights(get_weights(args.weights))
    evaluate_pairs(model, pairs[:1])  # warm-up: plans and kernels at the first shape
    if device.type == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    r = evaluate_pairs(model, pairs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / len(pairs)
    scores[label] = r
    print(f"{label}: N: {len(r.psnr)} PSNR: {np.mean(r.psnr):.4f} (std {np.std(r.psnr):.4f}) "
          f"SSIM: {np.mean(r.ssim):.6f} (std {np.std(r.ssim):.6f}); {ms:.2f} ms/image")
d = np.asarray(scores["bf16"].psnr) - np.asarray(scores["f32"].psnr)
s = np.asarray(scores["bf16"].ssim) - np.asarray(scores["f32"].ssim)
print(f"bf16 - f32 per image: PSNR mean {d.mean():+.4f} dB, max |.| {np.abs(d).max():.4f} dB; "
      f"SSIM mean {s.mean():+.6f}, max |.| {np.abs(s).max():.6f}")
EOF
stamp "bf16 serving check (f32 and bf16 models, 100 val images each)" "$t0"
smi >> "$EV/eval_bf16_serving.log"

if [ "$TASK" = sr ]; then
  python - "$EV" "$TAG" <<'EOF' | tee "$EV/compare.txt"
# The port's SR x2 epoch losses and scores beside the JAX package's run.
import csv, re, sys
ev, tag = sys.argv[1], sys.argv[2]
jax_ev = "experiments/evidence"
def losses(path):
    return {int(r["Epoch"]): float(r["Training Loss"]) for r in csv.DictReader(open(path))}
def summary(path):
    text = open(path).read()
    return {k: float(re.search(rf"^{k}: ([-0-9.]+)$", text, re.M).group(1)) for k in ("PSNR", "SSIM")}
port, ref = losses(f"{ev}/training.csv"), losses(f"{jax_ev}/sr2_r2r_training.csv")
print("epoch, port training loss, JAX training loss")
for e in sorted(set(port) | set(ref)):
    print(f"{e}, {port.get(e, float('nan')):.6e}, {ref.get(e, float('nan')):.6e}")
for name, data in (("port", port), ("JAX", ref)):
    low = min(data, key=data.get)
    print(f"{name}: lowest loss {data[low]:.6e} at epoch {low}; epoch 50 "
          f"{data.get(50, float('nan')):.6e}; last {data[max(data)]:.6e}")
print("port validation (16 val images): " + "; ".join(
    f"epoch {r['Epoch']} {float(r['PSNR']):.4f} / {float(r['SSIM']):.6f}"
    for r in csv.DictReader(open(f"{ev}/validation.csv"))))
for name, ref_log, dp, ds in ((tag, "eval_sr2_r2r_ep100.log", 0.5, 0.01),
                              ("sr2_upsample", "eval_sr2_upsample.log", 0.05, 0.005)):
    got, want = summary(f"{ev}/eval_{name}.log"), summary(f"{jax_ev}/{ref_log}")
    ok = abs(got["PSNR"] - want["PSNR"]) <= dp and abs(got["SSIM"] - want["SSIM"]) <= ds
    print(f"{name} (100 val images): port {got['PSNR']:.2f} / {got['SSIM']:.4f}, JAX "
          f"{want['PSNR']:.2f} / {want['SSIM']:.4f}; target within {dp} dB and {ds}: "
          f"{'met' if ok else 'MISSED'}")
EOF
  exit 0
fi

python - "$EV" "$EPOCHS" <<'EOF' | tee "$EV/compare.txt"
# The port's validation trajectory and scores beside the JAX package's run.
import csv, re, sys
ev, epochs = sys.argv[1], sys.argv[2]
jax_ev = "experiments/evidence"
def rows(path):
    return {int(r["Epoch"]): (float(r["PSNR"]), float(r["SSIM"])) for r in csv.DictReader(open(path))}
def summary(path):
    text = open(path).read()
    return {k: float(re.search(rf"^{k}: ([-0-9.]+)$", text, re.M).group(1)) for k in ("PSNR", "SSIM")}
port, ref = rows(f"{ev}/validation.csv"), rows(f"{jax_ev}/dl_g2_r2r_evalint_validation.csv")
print("epoch, port PSNR, JAX PSNR, port SSIM, JAX SSIM (16 val images)")
for e in sorted(set(port) | set(ref)):
    p, j = port.get(e, (float("nan"),) * 2), ref.get(e, (float("nan"),) * 2)
    print(f"{e}, {p[0]:.4f}, {j[0]:.4f}, {p[1]:.6f}, {j[1]:.6f}")
for tag, ref_log, dp, ds in ((f"r2r_ep{epochs}", "eval_dl_g2_r2r_evalint_ep100.log", 0.5, 0.01),
                             ("identity", "eval_identity_r3.log", 0.05, 0.005)):
    got, want = summary(f"{ev}/eval_{tag}.log"), summary(f"{jax_ev}/{ref_log}")
    ok = abs(got["PSNR"] - want["PSNR"]) <= dp and abs(got["SSIM"] - want["SSIM"]) <= ds
    print(f"{tag} (100 val images): port {got['PSNR']:.2f} / {got['SSIM']:.4f}, JAX "
          f"{want['PSNR']:.2f} / {want['SSIM']:.4f}; target within {dp} dB and {ds}: "
          f"{'met' if ok else 'MISSED'}")
EOF
