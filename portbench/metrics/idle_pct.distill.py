"""Device idle share over the traced distillation iterations, in percent
(the device under ``distill/loop.py`` -> ``distill/fused.py``)."""
from portbench.readers import idle_pct as read  # noqa: F401
