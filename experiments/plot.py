#!/usr/bin/env python
"""Figure generators for the experiment CSVs (results/plot.py analogue).

Each function takes the CSV written by run_experiments.py / run_gridsearch.py
and emits a PNG. Run with --all <outdir> to render every CSV found.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt


def _read(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _times(rows):
    """steady_s (new) or time_s (legacy) per row, with timeout flags."""
    if rows and "steady_s" in rows[0]:
        return ([float(r["steady_s"]) for r in rows],
                [bool(int(r.get("timed_out", 0))) for r in rows])
    return [float(r["time_s"]) for r in rows], [False] * len(rows)


def plot_g_time(path, out):
    rows = _read(path)
    g = [int(r["g"]) for r in rows]
    t, killed = _times(rows)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(g, t, marker="o", label="steady")
    if rows and "compile_s" in rows[0]:
        ax.plot(g, [float(r["compile_s"]) for r in rows], marker="s",
                alpha=0.5, label="compile+first")
        ax.legend(fontsize=8)
    for gi, ti, ki in zip(g, t, killed):
        if ki:
            ax.annotate("timeout", (gi, ti), fontsize=7)
    ax.set_xlabel("g (k = 6)")
    ax.set_ylabel("kernel time (s)")
    ax.set_yscale("log")
    ax.set_title(os.path.basename(path).replace(".csv", ""))
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_m_time(path, out):
    rows = _read(path)
    m = [int(r["m"]) for r in rows]
    t, _ = _times(rows)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(m, t, marker="o")
    ax.set_xlabel("m (g = 16)")
    ax.set_ylabel("kernel time (s)")
    ax.set_yscale("log")
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_i_auc(path, out):
    rows = _read(path)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot([int(r["I"]) for r in rows], [float(r["auc"]) for r in rows], marker="o")
    ax.set_xlabel("sampled iterations I")
    ax.set_ylabel("AUC")
    ax.set_xscale("log")
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_delta_auc(path, out):
    rows = _read(path)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(
        [float(r["delta"]) for r in rows], [float(r["auc"]) for r in rows], marker="o"
    )
    ax.set_xlabel("convergence delta")
    ax.set_ylabel("AUC")
    ax.set_xscale("log")
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_stdev_i(path, out):
    rows = _read(path)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    seeds = sorted({r["seed"] for r in rows})
    for s in seeds:
        pts = [(int(r["iteration"]), float(r["stdev"])) for r in rows
               if r["seed"] == s and int(r["iteration"]) > 1]
        if pts:
            ax.plot(*zip(*pts), alpha=0.7, label=f"seed {s}")
    ax.set_xlabel("iteration")
    ax.set_ylabel("convergence sd")
    ax.set_yscale("log")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_g_auc(path, out):
    rows = _read(path)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    for mode in ("exact", "approx"):
        pts = [(int(r["g"]), float(r["auc"])) for r in rows if r["mode"] == mode]
        if pts:
            ax.plot(*zip(*pts), marker="o", label=mode)
    ax.set_xlabel("g")
    ax.set_ylabel("AUC")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_chips(path, out):
    rows = _read(path)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    d = [int(r["devices"]) for r in rows]
    ax.plot(d, [float(r["speedup"]) for r in rows], marker="o", label="measured")
    ax.plot(d, d, linestyle="--", color="gray", label="linear")
    ax.set_xlabel("devices")
    ax.set_ylabel("speedup")
    if rows and rows[0].get("platform", "cpu") == "cpu":
        # virtual host devices share the physical cores, so wall-clock
        # saturates; the mesh path's integer-equality is tested separately
        # (tests/test_sharding.py) and real scaling needs real chips.
        ax.set_title(
            "single-host virtual mesh: devices share host cores",
            fontsize=8,
        )
    ax.legend()
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_speedup(path, out):
    """Per-dataset kernel speedup vs the measured reference single-thread
    wall (results/plot.py's speedup barchart family)."""
    rows = _read(path)
    names = [r["dataset"] for r in rows]
    sp = [float(r["speedup"]) for r in rows]
    fig, ax = plt.subplots(figsize=(max(5, 0.6 * len(rows)), 3.5))
    ax.bar(range(len(rows)), sp)
    ax.set_xticks(range(len(rows)))
    ax.set_xticklabels(names, rotation=45, ha="right", fontsize=8)
    ax.set_ylabel("speedup vs reference 1-thread")
    ax.set_yscale("log")
    for i, v in enumerate(sp):
        ax.annotate(f"{v:.0f}x", (i, v), ha="center", va="bottom", fontsize=7)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_stdev_ci(path, out):
    """Mean convergence-sd trajectory with a 95% CI band over seeds
    (results/run_experiments.py:1098-1195 methodology)."""
    import numpy as np

    rows = _read(path)
    seeds = sorted({r["seed"] for r in rows})
    by_iter = {}
    for r in rows:
        it = int(r["iteration"])
        if it > 1:
            by_iter.setdefault(it, []).append(float(r["stdev"]))
    its = sorted(by_iter)
    mean = np.array([np.mean(by_iter[i]) for i in its])
    sem = np.array([
        np.std(by_iter[i], ddof=1) / max(np.sqrt(len(by_iter[i])), 1)
        if len(by_iter[i]) > 1 else 0.0
        for i in its
    ])
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.plot(its, mean, label=f"mean of {len(seeds)} seeds")
    ax.fill_between(its, mean - 1.96 * sem, mean + 1.96 * sem, alpha=0.3,
                    label="95% CI")
    ax.set_xlabel("iteration")
    ax.set_ylabel("convergence sd")
    ax.set_yscale("log")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


# validated categorical slots 1-3 (fixed order, never cycled)
_CAT = ("#2a78d6", "#eb6834", "#1baf7a")


def plot_multiclass(path, out):
    """Grouped accuracy bars per corpus: kernel OvO vs linear OvR vs the
    sklearn (LIBSVM) precomputed-kernel oracle."""
    rows = _read(path)
    series = [
        ("kernel OvO", "ovo_acc"),
        ("linear OvR (EKM)", "linear_ovr_acc"),
        ("sklearn SVC oracle", "sklearn_ovo_acc"),
    ]
    x = range(len(rows))
    w = 0.26
    fig, ax = plt.subplots(figsize=(1.2 + 1.6 * len(rows), 3.5))
    for si, (label, key) in enumerate(series):
        vals = [float(r[key]) for r in rows]
        bars = ax.bar(
            [i + (si - 1) * (w + 0.02) for i in x], vals, w,
            color=_CAT[si], label=label,
        )
        for b, v in zip(bars, vals):
            ax.annotate(
                f"{v:.3f}", (b.get_x() + w / 2, v), ha="center",
                va="bottom", fontsize=7, color="#52514e",
            )
    ax.set_xticks(list(x))
    ax.set_xticklabels(
        [f"{r['dataset']}\n({r['classes']} classes)" for r in rows],
        fontsize=8,
    )
    ax.set_ylabel("test accuracy")
    ax.set_ylim(0, 1.05)
    ax.grid(axis="y", alpha=0.25, linewidth=0.5)
    ax.set_axisbelow(True)
    ax.legend(fontsize=8, frameon=False)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_sorted_approx(path, out):
    """Monte-Carlo pass throughput per sorted-engine configuration."""
    rows = _read(path)
    names = [f"{r['config']}\n(batch {r['theta_batch']})" for r in rows]
    v = [float(r["passes_per_s"]) for r in rows]
    fig, ax = plt.subplots(figsize=(1.5 + 1.2 * len(rows), 3.5))
    bars = ax.bar(range(len(rows)), v, 0.6, color=_CAT[0])
    for b, vi in zip(bars, v):
        ax.annotate(
            f"{vi:.2f}", (b.get_x() + 0.3, vi), ha="center",
            va="bottom", fontsize=8, color="#52514e",
        )
    ax.set_xticks(range(len(rows)))
    ax.set_xticklabels(names, fontsize=8)
    ax.set_ylabel("counting passes / s (steady)")
    ax.grid(axis="y", alpha=0.25, linewidth=0.5)
    ax.set_axisbelow(True)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_oracle_tools(path, out):
    """Measured third-party tool comparison (the reference's
    run_gkm.py / gkm_dna_tests.py figure family, from REAL runs of the
    vendored gkmSVM-2.0/LSGKM builds — results_baselines/
    oracle_comparison.csv): log-scale kernel/train walls per dataset for
    gkmSVM-2.0 (CPU, 4 threads), LSGKM, and ours (steady, on the device
    the CSV names), with
    each bar's AUC annotated."""
    rows = _read(path)
    series = [
        ("gkmSVM-2.0 kernel", "gkm_kernel_s", "gkm_auc", _CAT[1]),
        ("LSGKM train", "lsgkm_train_s", "lsgkm_auc", _CAT[2]),
        ("ours kernel", "ours_kernel_steady_s", "ours_auc", _CAT[0]),
    ]
    names = [f"{r['dataset']}\ng={r['g']} m={r['m']}" for r in rows]
    fig, ax = plt.subplots(figsize=(1.8 + 1.9 * len(rows), 4.0))
    width = 0.26
    for si, (label, tcol, acol, color) in enumerate(series):
        xs, vs, aucs = [], [], []
        for xi, r in enumerate(rows):
            try:
                vs.append(float(r[tcol]))
            except (KeyError, ValueError):
                continue
            xs.append(xi + (si - 1) * width)
            try:
                aucs.append(f"{float(r[acol]):.3f}")
            except (KeyError, ValueError):
                aucs.append("")
        bars = ax.bar(xs, vs, width, color=color, label=label)
        for b, vi, auc in zip(bars, vs, aucs):
            ax.annotate(
                f"{vi:.3g}s\n{auc}", (b.get_x() + width / 2, vi),
                ha="center", va="bottom", fontsize=7, color="#52514e",
            )
    ax.set_xticks(range(len(rows)))
    ax.set_xticklabels(names, fontsize=8)
    ax.set_yscale("log")
    ax.set_ylabel("wall (s, log scale)")
    ax.set_title("measured tool comparison (AUC under each bar)")
    ax.grid(axis="y", alpha=0.25, linewidth=0.5)
    ax.set_axisbelow(True)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_trainsize(path, out, fastsk_auc=None):
    """DL-baseline train-size curves (the reference's
    trainsize_varyresults family, results/neural_nets/run_cnn.py): mean
    AUC ± sd across seeds vs train fraction, one line per model, with the
    fastsk exact-kernel AUC as the reference line. Reads the
    ``<ds>_<model>_trainsize.csv`` files next to ``path`` (pass any one
    of them)."""
    import os as _os

    d = _os.path.dirname(path)
    # path is <ds>_<model>_trainsize.csv; ds itself may contain
    # underscores (EP300_47848), so strip the two known suffix parts
    ds = _os.path.basename(path).rsplit("_", 2)[0]
    if fastsk_auc is None:
        # the exact-kernel reference line lives in fastsk_ref.csv next
        # to the sweeps (our measured exact AUCs, RESULTS.md section 2)
        ref = _os.path.join(d, "fastsk_ref.csv")
        if _os.path.exists(ref):
            for r in _read(ref):
                if r["dataset"] == ds:
                    fastsk_auc = float(r["auc"])
    fig, ax = plt.subplots(figsize=(4.6, 3.5))
    for si, model in enumerate(("cnn", "lstm")):
        fp = _os.path.join(d, f"{ds}_{model}_trainsize.csv")
        if not _os.path.exists(fp):
            continue
        rows = _read(fp)
        fracs = sorted({float(r["fraction"]) for r in rows})
        mean, sd = [], []
        for fr in fracs:
            v = [float(r["auc"]) for r in rows if float(r["fraction"]) == fr]
            mean.append(sum(v) / len(v))
            sd.append((sum((x - mean[-1]) ** 2 for x in v) / len(v)) ** 0.5)
        ax.errorbar(
            fracs, mean, yerr=sd, marker="o", ms=4, capsize=3,
            color=_CAT[si + 1], label=model.upper(),
        )
    if fastsk_auc is not None:
        ax.axhline(
            fastsk_auc, color=_CAT[0], linewidth=1.2, linestyle="--",
            label="fastsk exact (full train)",
        )
    ax.set_xlabel("train fraction")
    ax.set_ylabel("test AUROC (mean ± sd over seeds)")
    ax.set_title(ds, fontsize=10)
    ax.grid(alpha=0.25, linewidth=0.5)
    ax.set_axisbelow(True)
    ax.legend(fontsize=8, frameon=False)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_e2e(path, out):
    """Host-pull vs device-resident end-to-end workflow phases
    (run_e2e_device.py): stacked kernel/fit/score bars, steady reps."""
    rows = _read(path)
    last_rep = max(int(r["rep"]) for r in rows)
    steady = {r["mode"]: r for r in rows if int(r["rep"]) == last_rep}
    modes = [m for m in ("host", "device") if m in steady]
    phases = [("kernel", "kernel_s"), ("fit", "fit_s"), ("score", "score_s")]
    fig, ax = plt.subplots(figsize=(5.2, 2.6))
    for yi, mode in enumerate(modes):
        left = 0.0
        for pi, (label, key) in enumerate(phases):
            v = float(steady[mode][key])
            ax.barh(
                yi, v, left=left, color=_CAT[pi], height=0.55,
                label=label if yi == 0 else None,
            )
            left += v
        ax.annotate(
            f" {left:.1f}s  (AUC {float(steady[mode]['auc']):.4f})",
            (left, yi), va="center", fontsize=8,
        )
    ax.set_yticks(range(len(modes)))
    ax.set_yticklabels(
        ["host pull" if m == "host" else "device-resident" for m in modes],
        fontsize=9,
    )
    ax.set_xlabel("steady end-to-end wall (s): kernel + fit + score")
    if len(modes) == 2:
        sp = float(steady["host"]["e2e_s"]) / max(
            float(steady["device"]["e2e_s"]), 1e-9
        )
        ax.set_title(
            os.path.basename(path).replace("_e2e.csv", "")
            + f" — {sp:.1f}x end to end",
            fontsize=9,
        )
    ax.margins(x=0.22)
    ax.legend(fontsize=8, frameon=False, loc="upper right", ncols=3)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


PLOTTERS = {
    "g_time": plot_g_time,
    "m_time": plot_m_time,
    "I_auc": plot_i_auc,
    "delta_auc": plot_delta_auc,
    "stdev_I": plot_stdev_i,
    "g_auc": plot_g_auc,
    "chips": plot_chips,
    "speedup": plot_speedup,
    "stdev_ci": plot_stdev_ci,
    "multiclass": plot_multiclass,
    "sorted_approx": plot_sorted_approx,
    "trainsize": plot_trainsize,
    "e2e": plot_e2e,
    "comparison": plot_oracle_tools,
}



def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", metavar="DIR", help="render every known CSV in DIR")
    ap.add_argument("--csv", help="one CSV to render")
    ap.add_argument("--kind", choices=sorted(PLOTTERS), help="plot type for --csv")
    ap.add_argument(
        "--bigfig", nargs="+", metavar="CSV",
        help="tile several datasets' CSVs of --kind into one grid "
             "(the reference's bigfig_* family)",
    )
    ap.add_argument("--out", help="output PNG for --bigfig")
    args = ap.parse_args(argv)

    if args.bigfig:
        out = args.out or f"bigfig_{args.kind}.png"
        plot_bigfig(args.bigfig, args.kind, out)
        print(f"rendered {out}")
        return
    if args.csv:
        PLOTTERS[args.kind](args.csv, args.csv.replace(".csv", ".png"))
        return
    if args.all:
        seen_trainsize = set()
        for path in glob.glob(os.path.join(args.all, "*.csv")):
            for kind, fn in PLOTTERS.items():
                if not path.endswith(f"_{kind}.csv"):
                    continue
                if kind == "trainsize":
                    # one figure per dataset (the generator reads every
                    # model's CSV itself), named <ds>_trainsize.png
                    ds = os.path.basename(path).rsplit("_", 2)[0]
                    if ds in seen_trainsize:
                        continue
                    seen_trainsize.add(ds)
                    out = os.path.join(args.all, f"{ds}_trainsize.png")
                    fn(path, out)
                else:
                    fn(path, path.replace(".csv", ".png"))
                print(f"rendered {path}")
        pj = os.path.join(args.all, "parity_full.json")
        if os.path.exists(pj):
            plot_parity_scatter(pj, os.path.join(args.all, "parity_scatter.png"))
            plot_auc_bars(pj, os.path.join(args.all, "parity_auc_bars.png"))
            print(f"rendered parity figures from {pj}")
        pjs = [
            p for n in ("parity_full.json", "parity_full2.json",
                        "parity_approx.json", "parity_approx2.json")
            if os.path.exists(p := os.path.join(args.all, n))
        ]
        if pjs:
            plot_auc_panels(pjs, os.path.join(args.all, "parity_auc_panels.png"))
            print("rendered parity_auc_panels.png")
        sp = os.path.join(args.all, "results_speedup", "suite_speedup.csv")
        if os.path.exists(sp):
            plot_speed_panels(sp, sp.replace("suite_speedup.csv",
                                             "suite_speed_panels.png"))
            print("rendered suite_speed_panels.png")


def plot_parity_scatter(json_path, out):
    """Published exact AUC vs ours, one point per dataset (the Table1/
    Table2 reproduction view) — reads the parity_*.json artifacts."""
    import json

    rows = json.load(open(json_path))
    pub = [r["published_exact"] for r in rows if r.get("published_exact")]
    ours = [r["exact_auc"] for r in rows if r.get("published_exact")]
    names = [r["dataset"] for r in rows if r.get("published_exact")]
    fig, ax = plt.subplots(figsize=(4.5, 4.5))
    ax.plot([0.5, 1.0], [0.5, 1.0], linestyle="--", color="gray", lw=1)
    ax.scatter(pub, ours, s=18)
    for x, y, n in zip(pub, ours, names):
        if abs(x - y) > 0.01:
            ax.annotate(n, (x, y), fontsize=6)
    ax.set_xlabel("published exact AUC")
    ax.set_ylabel("fastsk-jax exact AUC")
    ax.set_title("AUC parity (labels mark >0.01 outliers,\nall shown reference-side artifacts)", fontsize=9)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_auc_bars(json_path, out):
    """Per-dataset AUC bars, ours vs published exact (multi-dataset
    panel family of results/plot.py)."""
    import json

    rows = [r for r in json.load(open(json_path)) if r.get("published_exact")]
    rows.sort(key=lambda r: r["dataset"])
    idx = range(len(rows))
    fig, ax = plt.subplots(figsize=(max(6, 0.45 * len(rows)), 3.5))
    w = 0.4
    ax.bar([i - w / 2 for i in idx], [r["exact_auc"] for r in rows], w,
           label="fastsk-jax exact")
    ax.bar([i + w / 2 for i in idx], [r["published_exact"] for r in rows], w,
           label="published exact", alpha=0.7)
    ax.set_xticks(list(idx))
    ax.set_xticklabels([r["dataset"] for r in rows], rotation=60,
                       ha="right", fontsize=7)
    ax.set_ylim(0.5, 1.02)
    ax.set_ylabel("AUC")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


# ------------------------------------------------------- paper panel figures

_DOMAIN = {
    **{d: "DNA (TFBS)" for d in (
        "CTCF", "EP300", "EP300_47848", "JUND", "KAT2B", "RAD21", "SIN3A",
        "TP53", "ZZZ3", "NR2C2", "Pbde", "Hek29", "Mcf7")},
    **{d: "protein (SCOP)" for d in (
        "1.1", "1.34", "2.19", "2.31", "2.34", "2.41", "2.8", "3.19",
        "3.25", "3.33", "3.50")},
    **{d: "NLP" for d in (
        "AImed", "BioInfer", "CC1-LLL", "CC2-IEPA", "CC3-HPRD50",
        "DrugBank", "MedLine", "sentiment", "webkb")},
}
_DOMAIN_ORDER = ["DNA (TFBS)", "protein (SCOP)", "NLP"]


def _merge_parity(json_paths):
    import json

    rows = {}
    for path in json_paths:
        for r in json.load(open(path)):
            rows.setdefault(r["dataset"], {}).update(r)
    return rows


def plot_auc_panels(json_paths, out):
    """Table1/Table2-style all-dataset AUC panels (one per domain):
    grouped bars of our exact / our approx / published exact AUC for
    every dataset with parity data — the multi-dataset family of
    results/plot.py:44-1587 the single-CSV generators didn't cover."""
    rows = _merge_parity(json_paths)
    panels = {d: [] for d in _DOMAIN_ORDER}
    for name, r in sorted(rows.items()):
        dom = _DOMAIN.get(name)
        if dom and r.get("exact_auc") is not None:
            panels[dom].append((name, r))
    panels = {d: v for d, v in panels.items() if v}

    fig, axes = plt.subplots(
        1, len(panels),
        figsize=(1.1 + 0.52 * sum(len(v) for v in panels.values()), 3.4),
        gridspec_kw={"width_ratios": [len(v) for v in panels.values()]},
        squeeze=False,
    )
    for ax, (dom, items) in zip(axes[0], panels.items()):
        idx = range(len(items))
        w = 0.27
        ax.bar([i - w for i in idx],
               [r.get("exact_auc") or 0 for _, r in items], w,
               label="ours exact")
        ax.bar(list(idx),
               [r.get("approx_auc") or float("nan") for _, r in items], w,
               label="ours approx")
        ax.bar([i + w for i in idx],
               [r.get("published_exact") or float("nan") for _, r in items],
               w, label="published exact", alpha=0.75)
        ax.set_xticks(list(idx))
        ax.set_xticklabels([n for n, _ in items], rotation=70,
                           ha="right", fontsize=7)
        ax.set_ylim(0.5, 1.03)
        ax.set_title(dom, fontsize=9)
        ax.grid(axis="y", alpha=0.25, lw=0.5)
    axes[0][0].set_ylabel("test AUC")
    axes[0][-1].legend(fontsize=7, loc="lower right")
    fig.suptitle(
        "AUC across the full published suite (Table1/Table2 analogue)",
        fontsize=10,
    )
    fig.tight_layout(rect=(0, 0, 1, 0.95))
    fig.savefig(out, dpi=150)


def plot_speed_panels(csv_path, out):
    """Figure5-style per-dataset kernel-time comparison: measured
    reference C++ single-thread exact wall vs our steady device wall (log
    scale), speedup annotated, grouped by domain."""
    rows = _read(csv_path)
    for r in rows:
        r["_dom"] = _DOMAIN.get(r["dataset"], "other")
    rows.sort(key=lambda r: (_DOMAIN_ORDER.index(r["_dom"])
                             if r["_dom"] in _DOMAIN_ORDER else 9,
                             r["dataset"]))
    idx = range(len(rows))
    fig, ax = plt.subplots(figsize=(1.5 + 0.55 * len(rows), 3.6))
    w = 0.4
    ax.bar([i - w / 2 for i in idx],
           [float(r["ref_exact_s"]) for r in rows], w,
           label="reference C++ exact (1 thread, measured)")
    ax.bar([i + w / 2 for i in idx],
           [float(r["ours_steady_s"]) for r in rows], w,
           label="fastsk-jax exact (1 chip, steady)")
    for i, r in zip(idx, rows):
        ax.annotate(f'{float(r["speedup"]):.0f}x',
                    (i, float(r["ours_steady_s"])),
                    textcoords="offset points", xytext=(8, 2),
                    fontsize=7, rotation=90)
    ax.set_yscale("log")
    ax.set_xticks(list(idx))
    ax.set_xticklabels(
        [f'{r["dataset"]}\n(g{r["g"]} m{r["m"]})' for r in rows],
        fontsize=7,
    )
    ax.set_ylabel("exact kernel wall (s, log)")
    # domain separators
    prev = None
    for i, r in zip(idx, rows):
        if prev is not None and r["_dom"] != prev:
            ax.axvline(i - 0.5, color="gray", lw=0.6, alpha=0.5)
        prev = r["_dom"]
    ax.legend(fontsize=8)
    ax.set_title("Exact kernel computation, per dataset (Figure5 analogue)",
                 fontsize=10)
    fig.tight_layout()
    fig.savefig(out, dpi=150)


def plot_bigfig(csv_paths, kind, out):
    """Multi-dataset sweep grid (the reference's bigfig_* family,
    results/plot.py:312-833): one subplot per dataset CSV of the same
    sweep kind (g_time / m_time / I_auc / delta_auc / stdev_I), shared
    axes labels, dataset names as titles."""
    single = {
        "g_time": plot_g_time,
        "m_time": plot_m_time,
        "I_auc": plot_i_auc,
        "delta_auc": plot_delta_auc,
        "stdev_I": plot_stdev_i,
    }[kind]
    n = len(csv_paths)
    cols = min(3, n)
    rows_n = -(-n // cols)
    fig = plt.figure(figsize=(4.2 * cols, 3.2 * rows_n))
    for idx, path in enumerate(sorted(csv_paths)):
        name = os.path.basename(path).replace(f"_{kind}.csv", "")
        # each single-CSV generator draws on the current axes when given
        # ax=...; they create their own figure otherwise — render to a
        # temp figure and steal the axes content instead: simplest is to
        # re-draw with the shared logic below.
        ax = fig.add_subplot(rows_n, cols, idx + 1)
        _draw_sweep(ax, path, kind)
        ax.set_title(name, fontsize=9)
    fig.suptitle(f"{kind} across datasets (bigfig analogue)", fontsize=11)
    fig.tight_layout(rect=(0, 0, 1, 0.95))
    fig.savefig(out, dpi=150)


def _draw_sweep(ax, path, kind):
    rows = _read(path)
    if kind == "g_time":
        ts, to = _times(rows)
        ax.plot([int(r["g"]) for r in rows], ts, marker="o", ms=3)
        ax.set_xlabel("g (k=6)")
        ax.set_ylabel("steady kernel s")
        ax.set_yscale("log")
    elif kind == "m_time":
        ts, to = _times(rows)
        ax.plot([int(r["m"]) for r in rows], ts, marker="o", ms=3)
        ax.set_xlabel("m (g=16)")
        ax.set_ylabel("steady kernel s")
        ax.set_yscale("log")
    elif kind == "I_auc":
        ax.plot([int(r["I"]) for r in rows],
                [float(r["auc"]) for r in rows], marker="o", ms=3)
        ax.set_xscale("log")
        ax.set_xlabel("iterations I")
        ax.set_ylabel("AUC")
    elif kind == "delta_auc":
        ax.plot([float(r["delta"]) for r in rows],
                [float(r["auc"]) for r in rows], marker="o", ms=3)
        ax.set_xscale("log")
        ax.set_xlabel("delta")
        ax.set_ylabel("AUC")
    elif kind == "stdev_I":
        ax.plot([int(r["I"]) for r in rows],
                [float(r["stdev"]) for r in rows], marker="o", ms=3)
        ax.set_xlabel("iterations I")
        ax.set_ylabel("stdev")
    ax.grid(alpha=0.25, lw=0.5)


if __name__ == "__main__":
    main()
