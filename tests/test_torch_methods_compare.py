"""``tools_torch/methods_compare.py``, the ``compare.txt`` of
``FULL_RUN_TASK=methods`` and ``FULL_RUN_TASK=ct bash full_run_torch.sh``,
on fabricated evidence: eval logs in the port's ``cli.test`` form and the
JAX package's ``demo/test.py`` form, training CSVs in the form both trainers
write.  It checks the ``met`` / ``MISSED`` lines against 0.5 dB and 0.01
SSIM, the epoch alignment of the loss columns and the epoch from which they
part, a row trained at another seed beside the seed-less JAX row, and the
ordering line (with the JAX run's near ties)."""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mc():
    spec = importlib.util.spec_from_file_location(
        "methods_compare", os.path.join(ROOT, "tools_torch", "methods_compare.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_log(psnr, ssim):  # cli.test's last lines, then the card
    return (f"N: 100\nPSNR: {psnr:.2f}\nPSNR std: 0.50\nSSIM: {ssim:.4f}\nSSIM std: 0.0100\n"
            "LPIPS: n/a (no local LPIPS weights; pass --lpips_weights)\n"
            "NVIDIA H100 80GB HBM3, 700.00 W\n")


def jax_log(tag, psnr, ssim):  # demo/test.py's, with the queue script's heading
    return f"=== eval {tag} ===\n" + port_log(psnr, ssim).rsplit("NVIDIA", 1)[0]


def csv_text(losses):
    return "Epoch,Training Loss\n" + "".join(f"{e},{v!r}\n" for e, v in losses.items())


JAX_SCORES = {"eishift_ep100": (21.92, 0.7487), "css_ep100": (22.04, 0.8017),
              "sure_ep051": (21.70, 0.6748), "sure_ep100": (21.22, 0.6361),
              "eirot_ep100": (22.64, 0.7969), "eirs_ep100": (23.35, 0.8346),
              "sup_ep101": (26.34, 0.9410), "sup_ep201": (26.68, 0.9495),
              "sup_ep300": (26.92, 0.9543)}
JAX_CT_SCORES = {"ct_identity": (12.39, 0.2342), "ct_invfilter": (6.60, 0.0057),
                 "ct_sup_ep100": (15.56, 0.3728), "ct_n2i_ep100": (6.51, 0.0055),
                 "ct_r2r_ep100": (12.40, 0.2637)}


@pytest.fixture
def evidence(tmp_path):
    jax_ev, ev = tmp_path / "jax", tmp_path / "port"
    jax_ev.mkdir()
    ev.mkdir()
    for tag, (p, s) in JAX_SCORES.items():
        (jax_ev / f"eval_{tag}.log").write_text(jax_log(tag, p, s))
    for tag, (p, s) in JAX_CT_SCORES.items():  # the CT logs as the queue scripts kept them
        (jax_ev / f"eval_{tag}.log").write_text(jax_log(tag, p, s).split("\n", 1)[1])
    (jax_ev / "eval_dl_g2_r2r_evalint_ep100.log").write_text(port_log(25.64, 0.9245))
    (jax_ev / "eishift_training.csv").write_text(
        csv_text({e: 0.01 for e in range(1, 101)}))
    (jax_ev / "sup_300_training.csv").write_text(
        csv_text({e: 0.008 for e in range(1, 301)}))
    scaling = tmp_path / "eval_r2r_ep100.log"
    scaling.write_text(port_log(25.67, 0.9256))
    return ev, jax_ev, scaling


def run(mc, evidence, task="methods"):
    ev, jax_ev, scaling = evidence
    return mc.compare(str(ev), str(jax_ev), str(scaling), task)


def test_met_and_missed_lines(mc, evidence):
    ev = evidence[0]
    (ev / "eval_css_ep100.log").write_text(port_log(22.50, 0.8100))  # within both
    (ev / "eval_eirot_ep100.log").write_text(port_log(22.00, 0.7969))  # 0.64 dB short
    (ev / "eval_eishift_ep100.log").write_text(port_log(21.92, 0.7600))  # SSIM 0.0113 off
    (ev / "eval_sup_ep300.log").write_text(port_log(27.41, 0.9444))  # 0.49 dB, 0.0099 off
    lines = run(mc, evidence)
    by_tag = {line.split(":")[0]: line for line in lines if line.startswith(tuple(mc.ROWS))}
    assert by_tag["css css_ep100"] == ("css css_ep100: port 22.50 / 0.8100, JAX 22.04 / 0.8017 "
                                       "(eval_css_ep100.log): met")
    assert by_tag["eirot eirot_ep100"].endswith(": MISSED")
    assert "port 22.00 / 0.7969, JAX 22.64 / 0.7969" in by_tag["eirot eirot_ep100"]
    assert by_tag["eishift eishift_ep100"].endswith(": MISSED")
    assert by_tag["sup sup_ep300"].endswith(": met")
    assert by_tag["sup sup_ep101"] == "sup sup_ep101: not run; JAX 26.34 / 0.9410"
    assert sum(line.endswith("not run; JAX 21.22 / 0.6361") for line in lines) == 1
    assert len(by_tag) == len(JAX_SCORES)


def test_loss_columns_align_by_epoch(mc, evidence):
    ev = evidence[0]
    port = {e: 0.01 * (1.05 if e < 40 else 1.2) for e in range(1, 101)}  # parts at epoch 40
    port[1] = port[60] = 0.01  # apart at epoch 1 (the initial weights), together at 60
    del port[7]  # a missing epoch keeps its row, with "-"
    (ev / "eishift_training.csv").write_text(csv_text(port))
    (ev / "sup_training.csv").write_text(csv_text({e: 0.008 for e in range(1, 151)}))
    lines = run(mc, evidence)
    i = lines.index("eishift training loss by epoch: port, JAX (eishift_training.csv)")
    rows = lines[i + 1:i + 101]
    assert [int(r.split(",")[0]) for r in rows] == list(range(1, 101))
    assert rows[1] == f"  2, {0.0105:.6e}, {0.01:.6e}"
    assert rows[6] == f"  7, -, {0.01:.6e}"
    assert rows[99] == f"  100, {0.012:.6e}, {0.01:.6e}"
    assert "  eishift: the losses stay more than 10% of JAX's apart from epoch 61 on" in lines
    assert "  port: lowest 1.000000e-02 at epoch 1, last 1.200000e-02 at epoch 100" in lines
    j = lines.index("sup training loss by epoch: port, JAX (sup_300_training.csv)")
    sup = lines[j + 1:j + 301]
    assert sup[149] == f"  150, {0.008:.6e}, {0.008:.6e}" and sup[150] == f"  151, -, {0.008:.6e}"
    assert "  sup: the losses stay more than 10% of JAX's apart at no epoch to the end" in lines


@pytest.mark.parametrize("port_scores,same", [
    ({"eishift": 21.5, "css": 22.1, "eirot": 22.9, "sup": 27.0}, True),
    ({"eishift": 22.5, "css": 22.1, "eirot": 22.9, "sup": 27.0}, False),
])
def test_ordering_line(mc, evidence, port_scores, same):
    ev = evidence[0]
    for row, p in port_scores.items():
        (ev / f"eval_{mc.ROWS[row]['tags'][-1]}.log").write_text(port_log(p, 0.8))
    line = run(mc, evidence)[-1]
    first = min(port_scores, key=port_scores.get)
    port_part = " < ".join(f"{r} {p:.2f}" for r, p in sorted(
        [*port_scores.items(), ("scaling", 25.67)], key=lambda kv: kv[1]))
    assert line.startswith(f"Ordering by PSNR, low to high: port {port_part}; JAX ")
    assert line.startswith(f"Ordering by PSNR, low to high: port {first} ")
    assert ("JAX eishift 21.92 < css 22.04 < eirot 22.64 < scaling 25.64 < sup 26.92; "
            in line)
    assert line.endswith("the port reproduces the JAX ordering" if same
                         else "the port does NOT reproduce the JAX ordering")


@pytest.mark.parametrize("port_scores,verdict", [
    ({"n2i": 6.40, "invfilter": 6.62, "identity": 12.38, "r2r": 12.60, "sup": 15.3},
     "reproduces the JAX ordering"),
    ({"invfilter": 6.55, "n2i": 6.70, "r2r": 12.30, "identity": 12.39, "sup": 15.6},
     "reproduces the JAX ordering but for pairs the JAX run puts within 0.1 dB "
     "(n2i/invfilter, identity/r2r swapped)"),
    ({"n2i": 6.40, "invfilter": 6.62, "identity": 12.38, "sup": 12.50, "r2r": 15.0},
     "does NOT reproduce the JAX ordering"),
    ({"invfilter": 6.60, "identity": 12.39}, "reproduces the JAX ordering"),
])
def test_ct_ordering_line(mc, evidence, port_scores, verdict):
    ev = evidence[0]
    for row, p in port_scores.items():
        (ev / f"eval_{mc.CT_ROWS[row]['tags'][-1]}.log").write_text(port_log(p, 0.1))
    line = run(mc, evidence, "ct")[-1]
    port_part = " < ".join(f"{r} {p:.2f}" for r, p in sorted(port_scores.items(),
                                                              key=lambda kv: kv[1]))
    jax = sorted((r, JAX_CT_SCORES[mc.CT_ROWS[r]["tags"][-1]][0]) for r in port_scores)
    jax_part = " < ".join(f"{r} {p:.2f}" for r, p in sorted(jax, key=lambda kv: kv[1]))
    assert line == (f"Ordering by PSNR, low to high: port {port_part}; JAX {jax_part}; "
                    f"the port {verdict}")
    assert "scaling" not in line  # the deblurring full run is not a CT row


def test_ct_met_and_missed_lines(mc, evidence):
    ev = evidence[0]
    (ev / "eval_ct_identity.log").write_text(port_log(12.39, 0.2342))  # equal
    (ev / "eval_ct_invfilter.log").write_text(port_log(7.11, 0.0057))  # 0.51 dB above
    (ev / "eval_ct_sup_ep100.log").write_text(port_log(15.07, 0.3827))  # 0.49 dB, 0.0099
    (ev / "eval_ct_r2r_ep100.log").write_text(port_log(12.40, 0.2527))  # SSIM 0.011 short
    lines = run(mc, evidence, "ct")
    assert lines[0] == "Scores (100 val images); target within 0.5 dB and 0.01 SSIM of JAX:"
    assert lines[1:6] == [
        "identity ct_identity: port 12.39 / 0.2342, JAX 12.39 / 0.2342 (eval_ct_identity.log): "
        "met",
        "invfilter ct_invfilter: port 7.11 / 0.0057, JAX 6.60 / 0.0057 (eval_ct_invfilter.log): "
        "MISSED",
        "sup ct_sup_ep100: port 15.07 / 0.3827, JAX 15.56 / 0.3728 (eval_ct_sup_ep100.log): met",
        "n2i ct_n2i_ep100: not run; JAX 6.51 / 0.0055",
        "r2r ct_r2r_ep100: port 12.40 / 0.2527, JAX 12.40 / 0.2637 (eval_ct_r2r_ep100.log): "
        "MISSED",
    ]
    assert len(lines) == 7  # no loss lines: the JAX CT runs kept no training.csv
    (ev / "ct_r2r_training.csv").write_text(csv_text({1: 0.04}))
    assert run(mc, evidence, "ct") == lines


def test_seed_row_beside_the_seedless_jax_row(mc, evidence):
    ev = evidence[0]
    (ev / "eval_eishift_ep100.log").write_text(port_log(21.70, 0.7320))
    (ev / "eval_eishift_s1_ep100.log").write_text(port_log(21.80, 0.7420))
    (ev / "eval_eishift_s12_ep100.log").write_text(port_log(22.60, 0.7487))
    (ev / "eishift_training.csv").write_text(csv_text({e: 0.01 for e in range(1, 101)}))
    (ev / "eishift_s1_training.csv").write_text(
        csv_text({e: 0.01 * (1.2 if e >= 95 else 1.0) for e in range(1, 101)}))
    (ev / "eishift_s2_training.csv").write_text(csv_text({1: 0.02}))  # trained, not scored
    lines = run(mc, evidence)
    assert not any(line.startswith("eishift_s2 eishift_s2_ep100") for line in lines)  # unscored
    assert "eishift_s2 training loss by epoch: port, JAX (eishift_training.csv)" in lines
    assert lines[1:4] == [
        "eishift eishift_ep100: port 21.70 / 0.7320, JAX 21.92 / 0.7487 (eval_eishift_ep100.log): "
        "MISSED",
        "eishift_s1 eishift_s1_ep100: port 21.80 / 0.7420, JAX 21.92 / 0.7487 "
        "(eval_eishift_ep100.log): met",
        "eishift_s12 eishift_s12_ep100: port 22.60 / 0.7487, JAX 21.92 / 0.7487 "
        "(eval_eishift_ep100.log): MISSED",
    ]
    assert "eishift training loss by epoch: port, JAX (eishift_training.csv)" in lines
    i = lines.index("eishift_s1 training loss by epoch: port, JAX (eishift_training.csv)")
    assert lines[i + 95] == f"  95, {0.012:.6e}, {0.01:.6e}"
    assert "  eishift: the losses stay more than 10% of JAX's apart at no epoch to the end" in lines
    assert "  eishift_s1: the losses stay more than 10% of JAX's apart from epoch 95 on" in lines
    assert not any(line.startswith("eishift_s12 training") for line in lines)  # no CSV kept
    assert lines[-1].startswith("Ordering by PSNR, low to high: port eishift 21.70 < scaling")
    # a seed's row alone: the seed-less row still reads "not run"
    for name in ("eval_eishift_ep100.log", "eishift_training.csv"):
        (ev / name).unlink()
    lines = run(mc, evidence)
    assert lines[1] == "eishift eishift_ep100: not run; JAX 21.92 / 0.7487"
    assert lines[2].startswith("eishift_s1 eishift_s1_ep100: port 21.80 / 0.7420")


@pytest.mark.parametrize("task,tag,log,line", [
    ("methods", "css_ep100", port_log(22.04, 0.8017),
     "css css_ep100: port 22.04 / 0.8017, JAX 22.04 / 0.8017 (eval_css_ep100.log): met"),
    ("ct", "ct_n2i_ep100", port_log(6.66, 0.0058),
     "n2i ct_n2i_ep100: port 6.66 / 0.0058, JAX 6.51 / 0.0055 (eval_ct_n2i_ep100.log): met"),
])
def test_command_line_prints_the_comparison(mc, evidence, capsys, task, tag, log, line):
    ev, jax_ev, scaling = evidence
    (ev / f"eval_{tag}.log").write_text(log)
    mc.main([str(ev), "--task", task, "--jax_evidence", str(jax_ev),
             "--scaling_log", str(scaling)])
    out = capsys.readouterr().out.splitlines()
    assert out == run(mc, evidence, task)
    assert line in out
