"""The share of K1's forward points that the checkpointed renders
recompute in their backward, in percent: the points of the K1 forward
launches inside the ``render_bwd`` spans (the program's ``k1_points``
counter) over those plus the points the traced iterations' renders need
(the benchmark's count, ``portbench/spans.py::distill_counts``)."""
from portbench import spans


def read(ctx):
    win = spans.window(ctx)
    if win is None:
        return None
    recomputed = sum(spans.counted(s, {"render_bwd"}, "k1_points")
                     for _, s in win)
    forward = sum(spans.counted(s, {"render", "render_bwd"}, "k1_points")
                  for _, s in win)
    if forward <= 0:
        return None
    needed = spans.distill_counts(ctx["config"])["k1_points"] * len(win)
    return 100.0 * recomputed / (needed + recomputed)
