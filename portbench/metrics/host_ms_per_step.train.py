"""The host's own ms a train step (the program's ``train/step`` unit
with the spans before it: the batch its caller builds, ``train/batch``,
and the packing, ``train/pack``), less its loss reads' and its graph
launch's (``portbench/spans.py::host_ms_per_unit``)."""
from portbench import spans


def read(ctx):
    return spans.host_ms_per_unit(ctx)
