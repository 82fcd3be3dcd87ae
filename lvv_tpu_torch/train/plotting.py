"""Loss / metric curves, one PNG per epoch (the port's copy of
lvv_tpu/train/plotting.py). Needs matplotlib; the trainer skips the plot
without it."""
from __future__ import annotations

from typing import Dict, List


def plot_history(history: List[Dict], out_path) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    epochs = [h["epoch"] for h in history]
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].plot(epochs, [h.get("train_loss") for h in history],
                 label="train")
    if any("val_loss" in h for h in history):
        axes[0].plot([h["epoch"] for h in history if "val_loss" in h],
                     [h["val_loss"] for h in history if "val_loss" in h],
                     label="val")
    axes[0].set_xlabel("epoch")
    axes[0].set_ylabel("loss")
    axes[0].legend()
    axes[0].set_title("loss")

    cap = [(h["epoch"], h["inference"]["caption"]["bleu4"])
           for h in history
           if h.get("inference", {}).get("caption")]
    grd = [(h["epoch"], h["inference"]["grounding"]["top1_class_acc"])
           for h in history
           if h.get("inference", {}).get("grounding")]
    if cap:
        axes[1].plot(*zip(*cap), label="BLEU-4")
    if grd:
        axes[1].plot(*zip(*grd), label="top-1 cls")
    axes[1].set_xlabel("epoch")
    axes[1].legend()
    axes[1].set_title("task metrics")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
