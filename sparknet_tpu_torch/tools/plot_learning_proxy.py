"""Draw the learning proxy's figure: held-out accuracy against wall-clock
seconds and against iterations for 1x SGD, 8-way local SGD and the
hierarchical composition.

The port's counterpart of the root ``tools/plot_learning_proxy.py``.
SparkNet's headline plot (paper Fig. 5 family) shows test accuracy
against wall-clock time: local SGD with weight averaging reaches an
accuracy sooner than serial SGD although it is worse per iteration.
Each row's ``wall_s`` places it on the wall axis; a curve without it
has its ``final.wall_s_<tag>`` spread linearly over its iterations (said
in the subtitle), and a curve whose recorded wall is under 1 s is left
off the wall panel.  When the RESULTS file has a ``sweep``
(``tools/tausweep.py``), ``<out>_sweep.png`` draws the τ × codec grid:
color the codec, line style the τ, each cell's wire bytes in the legend.
matplotlib is imported inside the drawing functions only.

Run:  python -m sparknet_tpu_torch.tools.plot_learning_proxy
          [--in RESULTS_learning_proxy_torch.json] [--out FIG.png]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .learning_proxy import DEFAULT_OUT

# three categorical colors that stay apart for color-blind readers, and
# the text and surface colors
SERIES = (
    ("1x", "curve_1x", "wall_s_1x", "1× SGD", "#2a78d6"),
    ("8way", "curve_8way", "wall_s_8way", "8-way local SGD (τ=10)",
     "#eb6834"),
    ("hier", "curve_hier", "wall_s_hier", "hierarchical 2×4", "#1baf7a"),
)
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT_2 = "#52514e"
GRID = "#e4e3df"


def row_walls(curve, total_wall):
    """Per-row wall seconds: recorded ``wall_s`` when present, else the
    total spread linearly over iterations.  Returns (walls, synthesized)
    or (None, _) when no honest wall axis exists."""
    if all("wall_s" in r for r in curve):
        return [r["wall_s"] for r in curve], False
    if total_wall is None or total_wall < 1.0:
        return None, False
    last_iter = curve[-1]["iter"]
    return [total_wall * r["iter"] / last_iter for r in curve], True


def render(results, out_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_wall, ax_iter) = plt.subplots(
        1, 2, figsize=(11.5, 4.6), dpi=160)
    fig.patch.set_facecolor(SURFACE)

    synthesized = []
    dropped = []
    for ax in (ax_wall, ax_iter):
        ax.set_facecolor(SURFACE)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for side in ("left", "bottom"):
            ax.spines[side].set_color(GRID)
        ax.grid(True, color=GRID, linewidth=0.8)
        ax.set_axisbelow(True)
        ax.tick_params(colors=TEXT_2, labelsize=9)
        ax.set_ylabel("held-out accuracy", color=TEXT_2, fontsize=10)

    for tag, ckey, wkey, label, color in SERIES:
        curve = results.get(ckey)
        if not curve:
            dropped.append(label)
            continue
        iters = [r["iter"] for r in curve]
        acc = [r["test_acc"] for r in curve]
        ax_iter.plot(iters, acc, color=color, linewidth=2, label=label)
        walls, synth = row_walls(curve,
                                 results.get("final", {}).get(wkey))
        if walls is None:
            dropped.append(label)
        else:
            if synth:
                synthesized.append(tag)
            ax_wall.plot(walls, acc, color=color, linewidth=2,
                         label=label)
            # selective direct label at the line end (identity is never
            # color-alone)
            ax_wall.annotate(
                f"{tag} {acc[-1]:.3f}", (walls[-1], acc[-1]),
                textcoords="offset points", xytext=(6, -2),
                fontsize=9, color=TEXT)

    # the lr-drop schedule, on the iteration panel only (it is defined
    # in iterations)
    for sv in results.get("config", {}).get("stepvalues", []):
        ax_iter.axvline(sv, color=TEXT_2, alpha=0.35, linewidth=1,
                        linestyle=(0, (3, 3)))
    if results.get("config", {}).get("stepvalues"):
        # x in data coords, y in axes fraction — never clipped by ylim
        ax_iter.text(results["config"]["stepvalues"][0], 0.03, "lr ×0.1 ",
                     transform=ax_iter.get_xaxis_transform(),
                     ha="right", fontsize=8, color=TEXT_2)

    ax_wall.set_xlabel("wall-clock seconds", color=TEXT_2, fontsize=10)
    ax_iter.set_xlabel("iteration", color=TEXT_2, fontsize=10)
    ax_wall.set_title("accuracy vs wall clock — the paper's headline view",
                      color=TEXT, fontsize=11, loc="left")
    ax_iter.set_title("accuracy vs iteration (same runs)",
                      color=TEXT, fontsize=11, loc="left")
    ax_wall.legend(loc="lower right", fontsize=9, frameon=False,
                   labelcolor=TEXT)

    cfg = results.get("config", {})
    dev = results.get("device", "?")
    note = (f"cifar10_full @ 1/{cfg.get('scale', '?')} schedule "
            f"({cfg.get('max_iter', '?')} iters, batch "
            f"{cfg.get('batch', '?')}), synthetic texture set, {dev}")
    if synthesized:
        note += (f" — wall axis for {', '.join(synthesized)} "
                 f"reconstructed linearly from the curve's total "
                 f"(rows predate per-row wall_s)")
    if dropped:
        note += f" — dropped (no honest wall): {', '.join(dropped)}"
    fig.text(0.01, 0.01, note, fontsize=7.5, color=TEXT_2)
    fig.tight_layout(rect=(0, 0.04, 1, 1))
    fig.savefig(out_path, facecolor=SURFACE)
    plt.close(fig)
    return {"out": out_path, "synthesized_wall": synthesized,
            "dropped": dropped}


# codec -> categorical color; τ -> linestyle (identity never color-alone:
# the legend carries both fields textually)
SWEEP_CODEC_COLORS = {"none": "#2a78d6", "bf16": "#eb6834",
                      "int8": "#1baf7a", "int8_channel": "#8a63d2"}
SWEEP_TAU_STYLES = ("solid", (0, (5, 2)), (0, (1, 1)), (0, (3, 1, 1, 1)))


def render_sweep(sweep, out_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax_wall, ax_iter) = plt.subplots(
        1, 2, figsize=(11.5, 4.6), dpi=160)
    fig.patch.set_facecolor(SURFACE)
    for ax in (ax_wall, ax_iter):
        ax.set_facecolor(SURFACE)
        for side in ("top", "right"):
            ax.spines[side].set_visible(False)
        for side in ("left", "bottom"):
            ax.spines[side].set_color(GRID)
        ax.grid(True, color=GRID, linewidth=0.8)
        ax.set_axisbelow(True)
        ax.tick_params(colors=TEXT_2, labelsize=9)
        ax.set_ylabel("held-out accuracy", color=TEXT_2, fontsize=10)

    taus = sweep.get("config", {}).get("taus", [])
    for key, cell in sorted(sweep.get("cells", {}).items()):
        curve = cell.get("curve") or []
        if not curve:
            continue
        color = SWEEP_CODEC_COLORS.get(cell["codec"], TEXT_2)
        style = SWEEP_TAU_STYLES[
            taus.index(cell["tau"]) % len(SWEEP_TAU_STYLES)
            if cell["tau"] in taus else 0]
        mb = cell.get("exchange_bytes_per_round", 0) / 1e6
        label = (f"τ={cell['tau']} {cell['codec']} "
                 f"({mb:.2f} MB/round)")
        iters = [r["iter"] for r in curve]
        acc = [r["test_acc"] for r in curve]
        walls = [r["wall_s"] for r in curve]
        ax_iter.plot(iters, acc, color=color, linestyle=style,
                     linewidth=2, label=label)
        ax_wall.plot(walls, acc, color=color, linestyle=style,
                     linewidth=2, label=label)

    ax_wall.set_xlabel("wall-clock seconds", color=TEXT_2, fontsize=10)
    ax_iter.set_xlabel("iteration", color=TEXT_2, fontsize=10)
    ax_wall.set_title("τ × codec sweep — accuracy vs wall clock",
                      color=TEXT, fontsize=11, loc="left")
    ax_iter.set_title("same cells vs iteration",
                      color=TEXT, fontsize=11, loc="left")
    ax_wall.legend(loc="lower right", fontsize=8, frameon=False,
                   labelcolor=TEXT)

    cfg = sweep.get("config", {})
    boost = cfg.get("snr_boost", 1.0)
    boost_txt = "" if boost == 1.0 else f", SNR x{boost:g}"
    note = (f"cifar10_full @ 1/{cfg.get('scale', '?')} schedule, "
            f"base_lr {cfg.get('base_lr', '?')}, batch "
            f"{cfg.get('batch', '?')}, {cfg.get('workers', '?')} workers"
            f"{boost_txt}, {sweep.get('device', '?')} — delta exchange "
            f"w/ error feedback (parallel/comms.py)")
    fig.text(0.01, 0.01, note, fontsize=7.5, color=TEXT_2)
    fig.tight_layout(rect=(0, 0.04, 1, 1))
    fig.savefig(out_path, facecolor=SURFACE)
    plt.close(fig)
    return {"out": out_path}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="render the accuracy-vs-wall-clock figure")
    ap.add_argument("--in", dest="inp", default=DEFAULT_OUT)
    ap.add_argument("--out", default=None,
                    help="output PNG (default: <in> with .png)")
    args = ap.parse_args(argv)
    out = args.out or os.path.splitext(args.inp)[0] + ".png"
    with open(args.inp) as f:
        results = json.load(f)
    info = render(results, out)
    sweep_fig = None
    if results.get("sweep", {}).get("cells"):
        sweep_fig = render_sweep(
            results["sweep"],
            os.path.splitext(out)[0] + "_sweep.png")["out"]
    final = results.get("final", {})
    print(json.dumps({
        "figure": info["out"],
        "sweep_figure": sweep_fig,
        "acc_1x": final.get("acc_1x"),
        "acc_8way": final.get("acc_8way"),
        "acc_hier": final.get("acc_hier"),
        "wall_s": {t: final.get(w) for t, _, w, _, _ in SERIES},
        "synthesized_wall": info["synthesized_wall"],
        "dropped": info["dropped"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
