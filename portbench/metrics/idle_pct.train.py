"""Device idle share over the traced train steps, in percent (the device
under ``train/fused.py`` -> ``train/trainer.py``)."""
from portbench.readers import idle_pct as read  # noqa: F401
