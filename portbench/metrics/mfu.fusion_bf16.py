"""The fusion iteration's share of the chip's peak where the sampler's
UNet runs below the rest: the least seconds of the traced iterations'
model operations (``portbench/flops.py``), the UNet evaluations at the
peak of the configuration's ``sampler_precision`` and every other
operation at the peak of its ``precision``, over the window's seconds,
in percent.  The evaluations are the benchmark's count
(``spans.unet_evals``), each one ``spans.distill_counts``' UNet."""
from portbench import spans
from portbench.flops import PEAK_OPS, peak_ops


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.units or tr.window_s <= 0:
        return None
    config = ctx["config"]
    unet_ops = (spans.unet_evals(ctx) or 0) \
        * spans.distill_counts(config)["unet"]
    rest_ops = sum(u["ops"] for u in tr.units) - unet_ops
    least = unet_ops / PEAK_OPS[config["sampler_precision"]] \
        + rest_ops / peak_ops(config)
    return 100.0 * least / tr.window_s
