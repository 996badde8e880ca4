"""The benchmark's own operation and byte counts, over its reference
modules on the meta device."""
import dataclasses

import pytest

from portbench import flops
from portbench.reference.eft import EFTConfig
from portbench.reference.grid_encode import make_grid_encoding
from portbench.reference.ngp import NGPConfig
from portbench.reference.unet import UNetConfig
from portbench.reference.vae import VAEConfig


def test_unet_forward_per_sample():
    # the count the port's tools/flops.py gave when the benchmark was made
    assert flops.unet_fwd(dataclasses.asdict(UNetConfig()), 1) \
        == 62_830_217_216


def test_unet_forward_backward_at_the_diffusion_batch():
    assert flops.unet_fwd_bwd(dataclasses.asdict(UNetConfig()), 12) \
        == 2_261_887_819_776


def test_vae_and_eft():
    vae, eft = dataclasses.asdict(VAEConfig()), dataclasses.asdict(EFTConfig())
    assert flops.vae_encode(vae, 256) == 272_722_165_760
    assert [flops.eft_fwd_bwd(eft, 256, nc, 1024, 20) for nc in (2, 5)] \
        == [891_143_012_388, 2_231_814_070_362]


def test_ngp_mlp():
    ngp = dataclasses.asdict(NGPConfig())
    # (32 * 64 + 64 * 64 + 64 * 4) multiply-adds a point, forward, input
    # and weight gradients: 3 x 2 x 6400 operations
    assert flops.ngp_mlp_fwd_bwd(ngp, 1000) == 1000 * 3 * 2 * 6400


@pytest.mark.parametrize("mt, evals", [(0.0, 0), (0.001, 0), (0.06, 7),
                                       (0.5, 51), (0.99, 51)])
def test_plms_evals(mt, evals):
    assert flops.plms_evals(mt, 50) == evals


def test_k1_bytes_of_a_render_launch():
    enc = NGPConfig().encoding()
    b = flops.k1_launch_bytes(enc, 262_144)
    # PERF.md's bound of a launch on 262,144 render points: 0.0132 ms
    assert b["forward"] / flops.PEAK_BYTES * 1e3 == pytest.approx(0.0132,
                                                                  rel=0.01)
    assert b["backward"] == b["forward"]


def test_peaks():
    assert flops.peak_ops({"precision": "float32", "tf32": False}) == 67e12
    assert flops.peak_ops({"precision": "float32", "tf32": True}) == 495e12
    enc = make_grid_encoding(num_levels=2, level_dim=2, log2_hashmap_size=4)
    assert flops.k1_launch_bytes(enc, 1)["forward"] \
        == 12 + 16 + enc.total_params * 8
