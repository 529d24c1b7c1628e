#!/usr/bin/env python
"""The port's method-comparison rows beside the JAX package's.

``FULL_RUN_TASK=methods bash full_run_torch.sh`` trains each row of the
paper's method comparison (deblurring Gaussian_R2, noise 5, SwinIR, the
dead-leaves Div2K stand-in) with the JAX queue scripts' recipes and scores
it on the 100 val images; ``FULL_RUN_TASK=ct`` does the same for the
CT-like task's rows (Identity, InverseFilter, supervised, Noise2Inverse,
R2R-EI).  This script writes their ``compare.txt`` from the evidence
folder:

* the scores: each evaluated tag beside the JAX package's log of it, with
  ``met`` or ``MISSED`` against the full runs' target (0.5 dB and 0.01
  SSIM); a tag that has no port log yet reads ``not run``.  A row trained
  at another seed (``FULL_RUN_TRAIN_SEED``: ``eval_eishift_s1_ep100.log``,
  ``eishift_s1_training.csv``) is put beside the same JAX log and CSV as
  the seed-less row;
* the losses: where the JAX package kept the run's ``training.csv``
  (EI-shift, the 300-epoch supervised run), the two runs' epoch losses side
  by side and the epoch from which they stay more than ``PART_FRACTION``
  of the JAX loss apart (the first epochs differ by the initial weights);
* the ordering: the rows' PSNRs (each seed-less row's last tag; for the
  methods, the scaling row from the 100-epoch R2R-EI full run) from low to
  high, the port's and the JAX package's, and whether the port gives the
  JAX order, or gives it but for pairs that the JAX run puts within
  ``TIE_DB`` of each other.  It is reported, not gated.

    python tools_torch/methods_compare.py evidence_torch/methods
    python tools_torch/methods_compare.py --task ct evidence_torch/ct
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
TIE_DB = 0.1

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
# the CT-like task's rows (experiments/queue_r3r.sh, queue_r3t.sh); the JAX
# CT runs kept no training.csv
CT_ROWS: Dict[str, dict] = {
    "identity": {"tags": ["ct_identity"]},
    "invfilter": {"tags": ["ct_invfilter"]},
    "sup": {"tags": ["ct_sup_ep100"]},
    "n2i": {"tags": ["ct_n2i_ep100"]},
    "r2r": {"tags": ["ct_r2r_ep100"]},
}
TASKS = {"methods": ROWS, "ct": CT_ROWS}


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


def seed_suffixes(ev: str, row: str, spec: dict) -> List[str]:
    """The ``_s<seed>`` suffixes of the row's runs at other training seeds
    found in ``ev``, by seed."""
    pats = [re.compile(rf"^{row}_s(\d+)_training\.csv$")] + [
        re.compile("^eval_" + tag.replace(row, row + r"_s(\d+)", 1) + r"\.log$")
        for tag in spec["tags"]]
    seeds = {int(m.group(1)) for name in os.listdir(ev) for m in (p.match(name) for p in pats)
             if m}
    return [f"_s{seed}" for seed in sorted(seeds)]


def runs(ev: str, rows: Dict[str, dict]):
    """(row, spec, suffix): each row seed-less, then at each other seed."""
    for row, spec in rows.items():
        for suffix in ["", *seed_suffixes(ev, row, spec)]:
            yield row, spec, suffix


def score_lines(ev: str, jax_ev: str, rows: Dict[str, dict] = ROWS) -> List[str]:
    out = [f"Scores (100 val images); target within {PSNR_TOL} dB and {SSIM_TOL} SSIM of JAX:"]
    for row, spec, suffix in runs(ev, rows):
        for tag in spec["tags"]:
            port_tag = tag.replace(row, row + suffix, 1)
            want = summary(f"{jax_ev}/eval_{tag}.log")
            got = summary(f"{ev}/eval_{port_tag}.log")
            if got is None:
                if not suffix:
                    out.append(f"{row} {tag}: not run; JAX {want['PSNR']:.2f} / "
                               f"{want['SSIM']:.4f}")
                continue
            ok = (abs(got["PSNR"] - want["PSNR"]) <= PSNR_TOL
                  and abs(got["SSIM"] - want["SSIM"]) <= SSIM_TOL)
            out.append(f"{row}{suffix} {port_tag}: port {got['PSNR']:.2f} / {got['SSIM']:.4f}, "
                       f"JAX {want['PSNR']:.2f} / {want['SSIM']:.4f} (eval_{tag}.log): "
                       f"{'met' if ok else 'MISSED'}")
    return out


def loss_lines(ev: str, jax_ev: str, rows: Dict[str, dict] = ROWS) -> List[str]:
    out = []
    for base, spec, suffix in runs(ev, rows):
        row = base + suffix
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


def ordering_line(ev: str, jax_ev: str, scaling_log: Optional[str] = SCALING[1],
                  rows: Dict[str, dict] = ROWS) -> str:
    port, ref = {}, {}
    for row, spec in rows.items():
        got = summary(f"{ev}/eval_{spec['tags'][-1]}.log")
        if got is not None:
            port[row] = got["PSNR"]
            ref[row] = summary(f"{jax_ev}/eval_{spec['tags'][-1]}.log")["PSNR"]
    got = summary(scaling_log) if scaling_log else None
    if got is not None:
        port[SCALING[0]] = got["PSNR"]
        ref[SCALING[0]] = summary(f"{jax_ev}/{SCALING[2]}")["PSNR"]

    def order(d):
        return sorted(d, key=d.get)

    # the pairs the port puts the other way round from the JAX package
    swapped = [(a, b) for i, a in enumerate(order(port)) for b in order(port)[i + 1:]
               if ref[a] > ref[b]]
    if not swapped:
        verdict = "reproduces the JAX ordering"
    elif all(ref[a] - ref[b] <= TIE_DB for a, b in swapped):
        verdict = (f"reproduces the JAX ordering but for pairs the JAX run puts within {TIE_DB} "
                   "dB (" + ", ".join(f"{b}/{a}" for a, b in swapped) + " swapped)")
    else:
        verdict = "does NOT reproduce the JAX ordering"
    return ("Ordering by PSNR, low to high: port "
            + " < ".join(f"{r} {port[r]:.2f}" for r in order(port)) + "; JAX "
            + " < ".join(f"{r} {ref[r]:.2f}" for r in order(ref)) + f"; the port {verdict}")


def compare(ev: str, jax_ev: str = JAX_EVIDENCE, scaling_log: Optional[str] = SCALING[1],
            task: str = "methods") -> List[str]:
    rows = TASKS[task]
    if task != "methods":
        scaling_log = None  # the scaling row is the deblurring full run's
    return (score_lines(ev, jax_ev, rows) + loss_lines(ev, jax_ev, rows)
            + [ordering_line(ev, jax_ev, scaling_log, rows)])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("evidence",
                   help="the evidence folder (eval_<tag>.log, <row>_training.csv)")
    p.add_argument("--task", choices=sorted(TASKS), default="methods",
                   help="the row set: the deblurring method comparison or the CT-like task")
    p.add_argument("--jax_evidence", default=JAX_EVIDENCE)
    p.add_argument("--scaling_log", default=SCALING[1])
    args = p.parse_args(argv)
    print("\n".join(compare(args.evidence, args.jax_evidence, args.scaling_log, args.task)))


if __name__ == "__main__":
    main()
