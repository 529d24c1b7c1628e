#!/usr/bin/env python
"""The port's method-comparison rows beside the JAX package's.

``FULL_RUN_TASK=methods bash full_run_torch.sh`` trains each row of the
paper's method comparison (deblurring Gaussian_R2, noise 5, SwinIR, the
dead-leaves Div2K stand-in) with the JAX queue scripts' recipes and scores
it on the 100 val images; this script writes its ``compare.txt`` from the
evidence folder:

* the scores: each evaluated tag beside the JAX package's log of it, with
  ``met`` or ``MISSED`` against the full runs' target (0.5 dB and 0.01
  SSIM); a tag that has no port log yet reads ``not run``;
* the losses: where the JAX package kept the run's ``training.csv``
  (EI-shift, the 300-epoch supervised run), the two runs' epoch losses side
  by side and the epoch from which they stay more than ``PART_FRACTION``
  of the JAX loss apart (the first epochs differ by the initial weights);
* the ordering: the rows' PSNRs (each row's last tag; the scaling row from
  the 100-epoch R2R-EI full run) from low to high, the port's and the JAX
  package's, and whether the port gives the JAX order.  It is reported, not
  gated.

    python tools_torch/methods_compare.py evidence_torch/methods
"""

from __future__ import annotations

import argparse
import csv
import os
import re
from typing import Dict, List, Optional

JAX_EVIDENCE = "experiments/evidence"
PSNR_TOL, SSIM_TOL = 0.5, 0.01
PART_FRACTION = 0.10

# row -> its scored tags (each a port eval_<tag>.log beside the JAX log of
# the same name), and the JAX training.csv where the JAX run kept one.
ROWS: Dict[str, dict] = {
    "eishift": {"tags": ["eishift_ep100"], "jax_csv": "eishift_training.csv"},
    "css": {"tags": ["css_ep100"]},
    "sure": {"tags": ["sure_ep051", "sure_ep100"]},
    "eirot": {"tags": ["eirot_ep100"]},
    "eirs": {"tags": ["eirs_ep100"]},
    "sup": {"tags": ["sup_ep101", "sup_ep201", "sup_ep300"], "jax_csv": "sup_300_training.csv"},
}
# the proposed (scaling) row, trained by the default full run
SCALING = ("scaling", "evidence_torch/eval_r2r_ep100.log", "eval_dl_g2_r2r_evalint_ep100.log")


def summary(path: str) -> Optional[Dict[str, float]]:
    """PSNR and SSIM of a ``cli.test`` / ``demo/test.py`` log, None if the
    file is missing."""
    if not os.path.exists(path):
        return None
    text = open(path).read()
    return {k: float(re.search(rf"^{k}: ([-0-9.]+)$", text, re.M).group(1))
            for k in ("PSNR", "SSIM")}


def losses(path: str) -> Dict[int, float]:
    return {int(r["Epoch"]): float(r["Training Loss"]) for r in csv.DictReader(open(path))}


def score_lines(ev: str, jax_ev: str) -> List[str]:
    out = [f"Scores (100 val images); target within {PSNR_TOL} dB and {SSIM_TOL} SSIM of JAX:"]
    for row, spec in ROWS.items():
        for tag in spec["tags"]:
            want = summary(f"{jax_ev}/eval_{tag}.log")
            got = summary(f"{ev}/eval_{tag}.log")
            if got is None:
                out.append(f"{row} {tag}: not run; JAX {want['PSNR']:.2f} / {want['SSIM']:.4f}")
                continue
            ok = (abs(got["PSNR"] - want["PSNR"]) <= PSNR_TOL
                  and abs(got["SSIM"] - want["SSIM"]) <= SSIM_TOL)
            out.append(f"{row} {tag}: port {got['PSNR']:.2f} / {got['SSIM']:.4f}, JAX "
                       f"{want['PSNR']:.2f} / {want['SSIM']:.4f} (eval_{tag}.log): "
                       f"{'met' if ok else 'MISSED'}")
    return out


def loss_lines(ev: str, jax_ev: str) -> List[str]:
    out = []
    for row, spec in ROWS.items():
        if "jax_csv" not in spec or not os.path.exists(f"{ev}/{row}_training.csv"):
            continue
        port, ref = losses(f"{ev}/{row}_training.csv"), losses(f"{jax_ev}/{spec['jax_csv']}")
        out.append(f"{row} training loss by epoch: port, JAX ({spec['jax_csv']})")
        parted = None  # the first epoch from which every later one is apart
        for e in sorted(set(port) | set(ref)):
            p, j = port.get(e), ref.get(e)
            out.append(f"  {e}, {'-' if p is None else f'{p:.6e}'}, "
                       f"{'-' if j is None else f'{j:.6e}'}")
            if p is not None and j is not None:
                apart = abs(p - j) > PART_FRACTION * abs(j)
                parted = (parted or e) if apart else None
        for name, data in (("port", port), ("JAX", ref)):
            low = min(data, key=data.get)
            out.append(f"  {name}: lowest {data[low]:.6e} at epoch {low}, last "
                       f"{data[max(data)]:.6e} at epoch {max(data)}")
        out.append(f"  {row}: the losses stay more than {PART_FRACTION:.0%} of JAX's apart "
                   + (f"from epoch {parted} on" if parted else "at no epoch to the end"))
    return out


def ordering_line(ev: str, jax_ev: str, scaling_log: str = SCALING[1]) -> str:
    port, ref = {}, {}
    for row, spec in ROWS.items():
        got = summary(f"{ev}/eval_{spec['tags'][-1]}.log")
        if got is not None:
            port[row] = got["PSNR"]
            ref[row] = summary(f"{jax_ev}/eval_{spec['tags'][-1]}.log")["PSNR"]
    got = summary(scaling_log)
    if got is not None:
        port[SCALING[0]] = got["PSNR"]
        ref[SCALING[0]] = summary(f"{jax_ev}/{SCALING[2]}")["PSNR"]

    def order(d):
        return sorted(d, key=d.get)

    same = order(port) == order(ref)
    return ("Ordering by PSNR, low to high: port "
            + " < ".join(f"{r} {port[r]:.2f}" for r in order(port)) + "; JAX "
            + " < ".join(f"{r} {ref[r]:.2f}" for r in order(ref))
            + f"; the port {'reproduces' if same else 'does NOT reproduce'} the JAX ordering")


def compare(ev: str, jax_ev: str = JAX_EVIDENCE, scaling_log: str = SCALING[1]) -> List[str]:
    return (score_lines(ev, jax_ev) + loss_lines(ev, jax_ev)
            + [ordering_line(ev, jax_ev, scaling_log)])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("evidence",
                   help="the methods evidence folder (eval_<tag>.log, <row>_training.csv)")
    p.add_argument("--jax_evidence", default=JAX_EVIDENCE)
    p.add_argument("--scaling_log", default=SCALING[1])
    args = p.parse_args(argv)
    print("\n".join(compare(args.evidence, args.jax_evidence, args.scaling_log)))


if __name__ == "__main__":
    main()
