"""What the plotting CLIs share: matplotlib, imported where a figure is
drawn (the metrics themselves need none), and the save step."""

from __future__ import annotations

import os


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend unless one was chosen;
    raises ImportError where matplotlib is not installed."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def finish(fig, save_dir: str, show: bool, name: str) -> str:
    """Save ``fig`` as ``save_dir/name`` (150 dpi), show it when asked, close it."""
    plt = pyplot()
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, name)
    fig.savefig(path, dpi=150, bbox_inches="tight")
    print(f"saved {path}")
    if show:
        plt.show(block=True)
    plt.close(fig)
    return path
