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
# With FULL_RUN_TASK=denoisers, after step 1: the JAX package's denoiser
# priors trained by the port at the JAX scripts' defaults
# (experiments/train_drunet.py, 6000 steps, blind sigma ~ U(0, 55/255);
# experiments/train_diffunet.py, 6000 DDPM steps; their JAX logs
# experiments/evidence/drunet_training_r5.log and diffunet_training.log)
# through python -m sei_tpu_torch.cli.train_drunet / .cli.train_diffunet,
# then cli.test of PlugAndPlay, DiffPIR_DRUNet, DPS and DiffPIR_DiffUNet on
# val images 0-4 at deblurring Gaussian_R2 noise 5 with SEI_DRUNET_WEIGHTS /
# SEI_DIFFUNET_WEIGHTS on the new files, as
# experiments/eval_denoiser_baselines.sh ran them (JAX evidence:
# experiments/evidence/eval_pnp_r3.log, eval_dps_diffpir_r3_prefix.log,
# eval_dps_fixed.log, eval_diffpir_diffunet.log), then compare.txt with the
# training loss lines side by side.  The weights stay under $FULL_RUN_DIR;
# $FULL_RUN_DRUNET_ARGS / $FULL_RUN_DIFFUNET_ARGS add trainer flags (a CPU
# rehearsal: "--device cpu --steps 2 --channels 8 16 32 64 --nb 1" and
# "--device cpu --steps 2 --model_channels 32 --channel_mult 1 2
# --attention_ds 2").
# With FULL_RUN_TASK=methods, after step 1: the rows of the paper's method
# comparison named in $FULL_RUN_METHODS (default "css sup eirot eishift",
# cheapest first; "sure" and "eirs" are known too), each trained by
# cli.train with its JAX recipe's flags at --scan_steps 1 and no validation,
# as the JAX runs had none: eirot, --method ei-rotate r2r, f32, 100 epochs
# (experiments/queue_r3q.sh:70-75); eishift, --ProposedLoss__transforms
# Shifts r2r, f32, 100 epochs (experiments/queue_r3v.sh:36-40); css, --bf16,
# 100 epochs (queue_r3q.sh:64-68); sup, --bf16, 300 epochs
# (experiments/queue_r3m_regen.sh:41-46), scored at ckp_101, ckp_201 and
# weights.pt; sure, f32, 100 epochs, scored at ckp_051 and weights.pt
# (queue_r3q.sh:77-85); eirs, --ProposedLoss__transforms Rotations+Shifts
# r2r (experiments/queue_r3af.sh:35-40).  Each row runs under
# $FULL_RUN_DIR/methods/<row>; cli.test scores it on the 100 val images
# (eval_<row>_ep<epoch>.log), training.csv is kept as <row>_training.csv,
# and tools_torch/methods_compare.py writes compare.txt (the scores beside
# the JAX logs of the same names, the epoch losses beside the JAX
# training.csv where one was kept, and the rows' PSNR ordering).
# $FULL_RUN_TRAIN_SEED passes --seed to cli.train alone (cli.test scores the
# same 100 val degradations at every training seed) and suffixes the row's
# run, logs and tags with _s<seed> (eishift_s1, eval_eishift_s1_ep100.log,
# eishift_s1_training.csv), which methods_compare.py puts beside the JAX row
# of the seed-less name.
# With FULL_RUN_TASK=ct, after step 1: the CT-like task (--task
# invert_a_tomography_like_filter --noise_level 5, the separable ramp filter)
# as experiments/queue_r3r.sh and queue_r3t.sh ran it, the rows named in
# $FULL_RUN_CT_ROWS (default "identity invfilter sup n2i r2r", cheapest
# first): identity and invfilter, cli.test --model_kind Identity /
# InverseFilter (queue_r3r.sh:39-40); sup, --method sup --bf16
# (queue_r3r.sh:30-31); n2i, --method noise2inverse --bf16, scored by
# cli.test --noise2inverse, 4 forwards an image (queue_r3t.sh:21-28); r2r,
# --method proposed --ProposedLoss__sure_alternative r2r in f32
# (queue_r3r.sh:34-36); each trained 100 epochs at --scan_steps 1 with no
# validation under $FULL_RUN_DIR/ct/<row>, its training.csv kept as
# ct_<row>_training.csv, every row scored on the 100 val images
# (eval_ct_<row>.log, eval_ct_<row>_ep100.log), then compare.txt through
# tools_torch/methods_compare.py --task ct (the scores beside the JAX logs of
# the same names and the ordering; the JAX CT runs kept no training.csv).
# Every time is printed beside the card's name and power limit.
#
#   bash full_run_torch.sh                  # on one GPU, about 40 minutes
#   FULL_RUN_TASK=sr bash full_run_torch.sh # SR x2, about 40 minutes
#   FULL_RUN_TASK=baselines bash full_run_torch.sh  # evidence_torch/baselines/
#   FULL_RUN_TASK=denoisers bash full_run_torch.sh  # evidence_torch/denoisers/
#   FULL_RUN_TASK=methods bash full_run_torch.sh    # evidence_torch/methods/, ~95 minutes
#   FULL_RUN_TASK=methods FULL_RUN_METHODS=eishift FULL_RUN_TRAIN_SEED=1 \
#     bash full_run_torch.sh                        # EI-shift at seed 1, ~35 minutes
#   FULL_RUN_TASK=ct bash full_run_torch.sh         # evidence_torch/ct/, ~50 minutes
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
elif [ "$TASK" = denoisers ]; then
  EV=${FULL_RUN_EVIDENCE:-evidence_torch/denoisers}
  RUN=$RUN_ROOT/denoisers
  G2=(--task deblurring --kernel Gaussian_R2 --noise_level 5)
elif [ "$TASK" = methods ]; then
  EV=${FULL_RUN_EVIDENCE:-evidence_torch/methods}
  RUN=$RUN_ROOT/methods
  G2=(--task deblurring --kernel Gaussian_R2 --noise_level 5)
elif [ "$TASK" = ct ]; then
  EV=${FULL_RUN_EVIDENCE:-evidence_torch/ct}
  RUN=$RUN_ROOT/ct
  G2=(--task invert_a_tomography_like_filter --noise_level 5)
else
  echo "FULL_RUN_TASK: deblurring, sr, baselines, denoisers, methods or ct, got $TASK" >&2
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

if [ "$TASK" = denoisers ]; then
  mkdir -p "$RUN"
  read -r -a DRUNET_ARGS <<< "${FULL_RUN_DRUNET_ARGS:-}"
  read -r -a DIFFUNET_ARGS <<< "${FULL_RUN_DIFFUNET_ARGS:-}"
  t0=$(now)
  python -m sei_tpu_torch.cli.train_drunet --datasets_dir "$DATA" --out "$RUN/drunet.npz" \
    "${DRUNET_ARGS[@]}" 2>&1 | tee "$EV/drunet_training.log"
  stamp "cli.train_drunet (data read and init included)" "$t0"
  t0=$(now)
  python -m sei_tpu_torch.cli.train_diffunet --datasets_dir "$DATA" --out "$RUN/diffunet.pt" \
    "${DIFFUNET_ARGS[@]}" 2>&1 | tee "$EV/diffunet_training.log"
  stamp "cli.train_diffunet (data read and init included)" "$t0"
  for spec in "PlugAndPlay pnp_5imgs" "DiffPIR_DRUNet diffpir_drunet_5imgs" "DPS dps_5imgs" \
              "DiffPIR_DiffUNet diffpir_diffunet_5imgs"; do
    read -r kind tag <<< "$spec"
    t0=$(now)
    SEI_DRUNET_WEIGHTS="$RUN/drunet.npz" SEI_DIFFUNET_WEIGHTS="$RUN/diffunet.pt" \
      python -m sei_tpu_torch.cli.test "${G2[@]}" "${DD[@]}" --model_kind "$kind" \
      --indices 0,1,2,3,4 --print_all_metrics "${EXTRA[@]}" 2>&1 | tee "$EV/eval_$tag.log"
    stamp "cli.test $kind, val images 0,1,2,3,4 (reads and model build included)" "$t0"
    smi >> "$EV/eval_$tag.log"
  done
  python - "$EV" <<'EOF' | tee "$EV/compare.txt"
# The port's denoiser-prior scores beside the JAX package's, to 0.5 dB / 0.01,
# and the two trainings' loss lines side by side.
import re, sys
ev, jax_ev = sys.argv[1], "experiments/evidence"
def summary(path, section=None):
    text = open(path).read()
    if section is not None:  # one kind's block of a log that holds several
        text = text[text.index(f"=== eval {section} "):]
    return {k: float(re.search(rf"^{k}: ([-0-9.]+)$", text, re.M).group(1)) for k in ("PSNR", "SSIM")}
def losses(path):
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"^step (\d+)/\d+ loss ([-+.0-9e]+)", open(path).read(), re.M)}
rows = (("PlugAndPlay", "pnp_5imgs", "eval_pnp_r3.log", None),
        ("DiffPIR_DRUNet", "diffpir_drunet_5imgs", "eval_dps_diffpir_r3_prefix.log", "DiffPIR_DRUNet"),
        ("DPS", "dps_5imgs", "eval_dps_fixed.log", None),
        ("DiffPIR_DiffUNet", "diffpir_diffunet_5imgs", "eval_diffpir_diffunet.log", None))
for kind, tag, ref, section in rows:
    got, want = summary(f"{ev}/eval_{tag}.log"), summary(f"{jax_ev}/{ref}", section)
    ok = abs(got["PSNR"] - want["PSNR"]) <= 0.5 and abs(got["SSIM"] - want["SSIM"]) <= 0.01
    print(f"{kind} (val images 0-4): port {got['PSNR']:.2f} / {got['SSIM']:.4f}, JAX "
          f"{want['PSNR']:.2f} / {want['SSIM']:.4f} ({ref}); target within 0.5 dB and 0.01: "
          f"{'met' if ok else 'MISSED'}")
for name, ref in (("drunet", "drunet_training_r5.log"), ("diffunet", "diffunet_training.log")):
    port, jax = losses(f"{ev}/{name}_training.log"), losses(f"{jax_ev}/{ref}")
    print(f"{name} training loss, step: port, JAX ({ref})")
    for step in sorted(set(port) | set(jax)):
        print(f"  {step}: {port.get(step, '-')}, {jax.get(step, '-')}")
EOF
  exit 0
fi

if [ "$TASK" = methods ]; then
  SEED=(${FULL_RUN_TRAIN_SEED:+--seed "$FULL_RUN_TRAIN_SEED"})
  for method in ${FULL_RUN_METHODS:-css sup eirot eishift}; do
    row=$method${FULL_RUN_TRAIN_SEED:+_s$FULL_RUN_TRAIN_SEED}
    epochs=100 ckps=()
    case $method in
      eirot) flags=(--method ei-rotate --ProposedLoss__sure_alternative r2r) ;;
      eishift) flags=(--method proposed --ProposedLoss__transforms Shifts
                      --ProposedLoss__sure_alternative r2r) ;;
      css) flags=(--method css --bf16) ;;
      sup) flags=(--method sup --bf16) epochs=300 ckps=(101 201) ;;
      sure) flags=(--method sure) ckps=(051) ;;
      eirs) flags=(--method proposed --ProposedLoss__transforms Rotations+Shifts
                   --ProposedLoss__sure_alternative r2r) ;;
      *) echo "FULL_RUN_METHODS: css, sup, eirot, eishift, sure or eirs, got $method" >&2; exit 2 ;;
    esac
    epochs=${FULL_RUN_EPOCHS:-$epochs}
    t0=$(now)
    python -m sei_tpu_torch.cli.train "${G2[@]}" "${flags[@]}" "${DD[@]}" --epochs "$epochs" \
      --scan_steps 1 --out_dir "$RUN/$row" "${SEED[@]}" "${EXTRA[@]}" 2>&1 \
      | tee "$EV/${row}_train.log"
    stamp "cli.train $row, $epochs epochs (data read, warm-up, capture included)" "$t0"
    cp "$RUN/$row/training.csv" "$EV/${row}_training.csv"
    for ckp in "${ckps[@]}" weights; do
      if [ "$ckp" = weights ]; then w=$RUN/$row/weights.pt tag=${row}_ep$epochs
      else w=$RUN/$row/checkpoints/ckp_$ckp.pt tag=${row}_ep$ckp; fi
      if [ ! -f "$w" ]; then echo "no $w (a run of $epochs epochs): $tag not scored"; continue; fi
      t0=$(now)
      python -m sei_tpu_torch.cli.test "${G2[@]}" "${DD[@]}" --weights "$w" "${EXTRA[@]}" \
        2>&1 | tail -8 | tee "$EV/eval_$tag.log"
      stamp "cli.test $tag, 100 val images (reads and model build included)" "$t0"
      smi >> "$EV/eval_$tag.log"
    done
  done
  python tools_torch/methods_compare.py "$EV" | tee "$EV/compare.txt"
  exit 0
fi

if [ "$TASK" = ct ]; then
  for row in ${FULL_RUN_CT_ROWS:-identity invfilter sup n2i r2r}; do
    kind= test_flags=()
    case $row in
      identity) kind=Identity ;;
      invfilter) kind=InverseFilter ;;
      sup) flags=(--method sup --bf16) ;;
      n2i) flags=(--method noise2inverse --bf16) test_flags=(--noise2inverse) ;;
      r2r) flags=(--method proposed --ProposedLoss__sure_alternative r2r) ;;
      *) echo "FULL_RUN_CT_ROWS: identity, invfilter, sup, n2i or r2r, got $row" >&2; exit 2 ;;
    esac
    if [ -n "$kind" ]; then
      test_flags=(--model_kind "$kind") tag=ct_$row
    else
      t0=$(now)
      python -m sei_tpu_torch.cli.train "${G2[@]}" "${flags[@]}" "${DD[@]}" --epochs "$EPOCHS" \
        --scan_steps 1 --out_dir "$RUN/$row" "${EXTRA[@]}" 2>&1 | tee "$EV/ct_${row}_train.log"
      stamp "cli.train ct_$row, $EPOCHS epochs (data read, warm-up, capture included)" "$t0"
      cp "$RUN/$row/training.csv" "$EV/ct_${row}_training.csv"
      test_flags+=(--weights "$RUN/$row/weights.pt") tag=ct_${row}_ep$EPOCHS
    fi
    t0=$(now)
    python -m sei_tpu_torch.cli.test "${G2[@]}" "${DD[@]}" "${test_flags[@]}" "${EXTRA[@]}" \
      2>&1 | tail -8 | tee "$EV/eval_$tag.log"
    stamp "cli.test $tag, 100 val images (reads and model build included)" "$t0"
    smi >> "$EV/eval_$tag.log"
  done
  python tools_torch/methods_compare.py --task ct "$EV" | tee "$EV/compare.txt"
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
