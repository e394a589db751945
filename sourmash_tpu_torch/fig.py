"""Plotting for `sourmash plot`: clustered distance-matrix heatmap with a
dendrogram panel: the port's copy of `sourmash_tpu/fig.py` (parity:
reference `src/sourmash/fig.py`, plot_composite_matrix:26).

matplotlib and scipy are imported at first use, so that importing the
package needs neither.
"""

from __future__ import annotations

from .logging import error, notify

# composite-figure geometry: dendrogram at left, matrix centered (shifted
# left when labels are hidden), colorbar just right of the matrix
_FIG_SIZE = (11, 8)
_PANEL_Y, _PANEL_H = 0.1, 0.6
_DENDRO_AXES = [0.09, _PANEL_Y, 0.2, _PANEL_H]
_MATRIX_WIDTH = 0.45
_MATRIX_X = {True: 0.45, False: 0.315}  # keyed by show_labels


def _pyplot():
    "matplotlib's pyplot on the Agg backend."
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as pylab

    return pylab


def load_matrix_and_labels(basefile):
    "Load the comparison matrix and associated labels, return (D, labels)."
    import numpy

    with open(basefile, "rb") as fp:
        D = numpy.load(fp)
    with open(basefile + ".labels.txt") as fp:
        labeltext = [x.strip() for x in fp]
    return (D, labeltext)


def _coerce_to_distance(D, force):
    "Require values in [0, 1], rescaling only under --force."
    lo, hi = D.min(), D.max()
    if hi > 1.0 or lo < 0.0:
        error(
            "This matrix doesn't look like a distance matrix - min value {}, max value {}",
            lo,
            hi,
        )
        if not force:
            raise ValueError("not a distance matrix")
        notify("force is set; scaling to [0, 1]")
        D -= lo
        D /= D.max()
    return D


def _dendrogram_panel(fig, D, labeltext, show_labels):
    "Left panel: single-linkage dendrogram; returns the leaf ordering."
    import scipy.cluster.hierarchy as sch

    panel = fig.add_axes(_DENDRO_AXES)
    linkage = sch.linkage(D, method="single")

    if show_labels:
        dendrolabels = labeltext
    else:
        dendrolabels = [str(i) for i in range(len(labeltext))]

    tree = sch.dendrogram(
        linkage,
        orientation="left",
        labels=dendrolabels,
        no_labels=not show_labels,
        get_leaves=True,
    )
    panel.set_xticks([])
    return tree["leaves"]


def _heatmap_panel(fig, D, xstart, vmin, vmax):
    "Center panel: the reordered matrix, plus its colorbar at the right."
    pylab = _pyplot()
    panel = fig.add_axes([xstart, _PANEL_Y, _MATRIX_WIDTH, _PANEL_H])
    im = panel.matshow(
        D, aspect="auto", origin="lower", cmap=pylab.cm.YlGnBu, vmin=vmin, vmax=vmax
    )
    panel.set_xticks([])
    panel.set_yticks([])

    bar = fig.add_axes([xstart + _MATRIX_WIDTH + 0.01, _PANEL_Y, 0.02, _PANEL_H])
    pylab.colorbar(im, cax=bar)


def plot_composite_matrix(
    D, labeltext, show_labels=True, vmax=1.0, vmin=0.0, force=False
):
    """Build a composite plot: dendrogram + distance matrix/heatmap.

    Returns (figure, reordered labels, reordered matrix)."""
    D = _coerce_to_distance(D, force)
    if not show_labels:
        labeltext = [""] * len(labeltext)

    fig = _pyplot().figure(figsize=_FIG_SIZE)
    leaf_order = _dendrogram_panel(fig, D, labeltext, show_labels)

    # permute matrix + labels into dendrogram leaf order
    D = D[leaf_order, :][:, leaf_order]
    labeltext = [labeltext[idx] for idx in leaf_order]

    _heatmap_panel(fig, D, _MATRIX_X[bool(show_labels)], vmin, vmax)
    return fig, labeltext, D
