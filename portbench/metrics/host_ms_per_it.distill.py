"""The host's own ms a distillation iteration (the program's
``distill/iteration`` unit): its host time less its loss reads' and its
graph launches' (``portbench/spans.py::host_ms_per_unit``), what is left
being the draws, the Python between launches and any eager work."""
from portbench import spans


def read(ctx):
    return spans.host_ms_per_unit(ctx)
