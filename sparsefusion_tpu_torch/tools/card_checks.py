"""Card-against-CPU checks that ``chip_smoke.py`` and the card tests
(``tests/test_torch_kernels_cuda.py``) share.

:func:`occupancy_card_vs_cpu` runs the occupancy grid's update and its
near/far tightening (``render/occupancy.py``) on the card and on the CPU
from the same inputs and raises ``AssertionError`` where they part.
"""
from __future__ import annotations

import json

import numpy as np
import torch

# the loop's grid: 128^3 cells, bound 4 (3 cascades), the threshold cap
GRID_SIZE = 128
BOUND = 4.0
DENSITY_THRESH = 10.0
N_RAYS = 16384
N_PROBE = 64
# a probe this close to a cell face (in cells) or to a cascade's bound
# (relative) may read the neighbour's bit when its position differs by
# an ulp between the two devices
FACE_EPS = 1e-4
LEVEL_EPS = 1e-5


def ball_density(p: torch.Tensor) -> torch.Tensor:
    """An analytic density: 20 at the origin, falling off over 0.6."""
    return 20.0 * torch.exp(-(p ** 2).sum(dim=-1) / (2 * 0.6 ** 2))


def _rays_at_a_face(o, d, near, far, cascade):
    """(N,) bool: rays with a probe of ``occupancy_near_far`` within
    FACE_EPS of a cell face or LEVEL_EPS of a cascade's bound, by float64
    arithmetic on the CPU."""
    t = torch.linspace(0.0, 1.0, N_PROBE, dtype=torch.float64)
    near, far = near.double(), far.double()
    ts = near[:, None] + (far - near)[:, None] * t[None]
    pts = o.double()[:, None, :] + d.double()[:, None, :] * ts[..., None]
    mx = pts.abs().amax(dim=-1)
    level = torch.clamp(torch.ceil(torch.log2(torch.clamp(mx, min=1.0))),
                        0, cascade - 1)
    cas_bound = torch.minimum(2.0 ** level, torch.tensor(BOUND))
    pos = (pts / cas_bound[..., None] + 1.0) * 0.5 * GRID_SIZE
    at_face = ((pos - pos.round()).abs() <= FACE_EPS).any(dim=-1)
    at_level = torch.zeros_like(at_face)
    for c in range(1, cascade):
        edge = min(2.0 ** c, BOUND)
        at_level |= (mx - edge).abs() <= LEVEL_EPS * edge
    return (at_face | at_level).any(dim=-1)


def occupancy_card_vs_cpu(device="cuda"):
    """``density_grid_update`` (the jitter passed in, ``ball_density``)
    and ``occupancy_near_far`` (N_RAYS rays, N_PROBE probes) at the loop's
    grid, on ``device`` and on the CPU: the grid and the mean within 1e-6
    relative (exp differs by an ulp), the bitfield equal but for cells
    within 1e-6 relative of the threshold, and near/far within 1e-5
    relative with the same ``any_occ`` on every ray but those with a probe
    at a cell face.  Returns (the comparison's numbers, the CPU's
    bitfield); raises AssertionError, with those numbers, where the two
    devices part."""
    from sparsefusion_tpu_torch.render import occupancy as occ

    gs = GRID_SIZE
    cascade = occ.cascade_count(BOUND)
    gen = torch.Generator().manual_seed(0)
    jitter = torch.rand(cascade, gs ** 3, 3, generator=gen)
    out = {}
    for dev in ("cpu", device):
        grid, bits, mean = occ.density_grid_update(
            torch.zeros(cascade, gs ** 3, device=dev), ball_density, BOUND,
            gs, cascade, DENSITY_THRESH, jitter=jitter.to(dev))
        out[dev] = (grid.cpu(), bits.cpu(), float(mean))
    (g_c, b_c, m_c), (g_g, b_g, m_g) = out["cpu"], out[device]
    thresh = min(m_c, DENSITY_THRESH)
    flipped = torch.from_numpy(
        np.unpackbits(b_c.numpy(), bitorder="little")
        != np.unpackbits(b_g.numpy(), bitorder="little"))
    near_thresh = (g_c.reshape(-1) - thresh).abs() <= 1e-6 * thresh
    stats = {"grid_max_rel_err": ((g_c - g_g).abs().max()
                                  / g_c.abs().max()).item(),
             "mean_rel_err": abs(m_c - m_g) / abs(m_c),
             "bits_flipped": int(flipped.sum()),
             "bits_flipped_away_from_threshold": int(
                 (flipped & ~near_thresh).sum()),
             "occupied_share": float(np.unpackbits(b_c.numpy()).mean())}

    n = N_RAYS
    o = torch.randn(n, 3, generator=gen) * 3
    d = -o / o.norm(dim=-1, keepdim=True) \
        + 0.2 * torch.randn(n, 3, generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    near = torch.rand(n, generator=gen) * 2 + 0.1
    far = near + torch.rand(n, generator=gen) * 6
    res = {dev: [t.cpu() for t in occ.occupancy_near_far(
        b_c.to(dev), o.to(dev), d.to(dev), near.to(dev), far.to(dev), BOUND,
        gs, cascade, N_PROBE)] for dev in ("cpu", device)}
    (n_c, f_c, a_c), (n_g, f_g, a_g) = res["cpu"], res[device]
    close = ((n_c - n_g).abs() <= 1e-5 * n_c.abs()) \
        & ((f_c - f_g).abs() <= 1e-5 * f_c.abs()) & (a_c == a_g)
    at_face = _rays_at_a_face(o, d, near, far, cascade)
    stats.update({
        "near_max_rel_err": ((n_c - n_g).abs() / n_c).max().item(),
        "far_max_rel_err": ((f_c - f_g).abs() / f_c).max().item(),
        "rays_apart": int((~close).sum()),
        "rays_apart_away_from_faces": int((~close & ~at_face).sum()),
        "rays_with_a_probe_at_a_face": int(at_face.sum()),
        "rays": n, "rays_hit": int(a_c.sum())})
    finite = all(bool(torch.isfinite(t).all())
                 for t in (n_c, f_c, n_g, f_g))
    why = json.dumps(stats)
    assert stats["grid_max_rel_err"] <= 1e-6, why
    assert stats["mean_rel_err"] <= 1e-6, why
    assert stats["bits_flipped_away_from_threshold"] == 0, why
    assert 0.0 < stats["occupied_share"] < 1.0, why
    assert finite, why
    assert stats["rays_apart_away_from_faces"] == 0, why
    assert 0 < stats["rays_hit"] < n, why
    return stats, b_c
