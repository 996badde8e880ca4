"""The train step as one program (``TrainStep.program``, which
``train/fused.py`` captures into a CUDA graph per context size on the
card and runs eagerly here), against the JAX step, the eager step and
optax's guard; checkpoints between the two steps; the train CLI's read
cadence.

Tolerances:
* against the JAX step, those of ``test_torch_train_step.py``: losses
  1e-5 relative, gradients 1e-3 (Frobenius over each model);
* against the eager step on the same depth ranges (computed on the
  device, as the program computes them; the host floats' ``linspace``
  is within one ulp of it, ``test_torch_rays_tensor_depth.py``): draws
  bit-equal, losses and parameters within 1e-6 (they run the same
  operations, so they come out equal here);
* the device guard against a run that skipped the NaN step: bit-equal
  (parameters, both moments, Adam's step, the staircase), and against
  optax's ``apply_if_finite`` the parameters within 1e-6 (the update of
  ``test_torch_train_step.py``);
* checkpoints: a resumed run bit-equal to the uninterrupted one.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sparsefusion_tpu.train import trainer as jtrainer
from sparsefusion_tpu_torch.cli import train as train_cli
from sparsefusion_tpu_torch.train import trainer
from sparsefusion_tpu_torch.train.checkpoints import (
    restore_checkpoint,
    save_checkpoint,
)
from sparsefusion_tpu_torch.train.fused import FusedTrainStep, LossRing
from tests.test_torch_train_step import (
    DBS,
    LATENT,
    _port_models,
    _scenes,
    check_train_step_against_jax,
)

torch.set_num_threads(2)

CONTEXTS = ([1, 2], [1, 2, 3], [2, 4])      # sizes 2, 3, 2: a key met again


def _setup(seed=7):
    models = _port_models()
    cfg = trainer.TrainConfig(latent_size=LATENT, context_size=3,
                              diffusion_batch_size=DBS)
    unet_opt, eft_opt = trainer.make_optimizers(cfg, models)
    step = trainer.make_train_step(models, cfg, unet_opt, eft_opt)
    return models, step, torch.Generator().manual_seed(seed)


def _batch(scene, ctx, host_range=False):
    batch = trainer.prepare_scene_batch([scene], [0], [ctx])
    if not host_range:
        del batch["depth_range"]
    return batch


def _state(models, step):
    """Parameters and both optimizers' states, cloned."""
    out = {f"{m}.{n}": p.detach().clone()
           for m, module in (("unet", models.unet), ("eft", models.eft))
           for n, p in module.named_parameters()}
    for k, opt in enumerate(step.opts):
        for i, p in enumerate(opt.params):
            for key, v in opt.adam.state[p].items():
                out[f"opt{k}.{i}.{key}"] = v.clone()
        out[f"opt{k}.count"] = opt.schedule.count.clone()
        out[f"opt{k}.skipped"] = opt.skipped.clone()
    return out


def test_program_matches_jax_step():
    """The program, run eagerly, against the JAX ``make_train_step``: the
    EFT trained, one scene, the depth range from the context cameras on
    the device."""
    check_train_step_against_jax(train_eft=True, n_scenes=1, program=True)


def test_fused_step_matches_eager_step():
    """Three steps of ``FusedTrainStep`` (static buffers per context
    size, the device guard) and of the eager step, each from a generator
    of one seed, context sizes 2, 3, 2."""
    _, scenes = _scenes(1)
    runs = {}
    for kind in ("eager", "fused"):
        models, step, gen = _setup()
        fused = FusedTrainStep(step, gen)
        losses, draws = [], []
        for ctx in CONTEXTS:
            batch = _batch(scenes[0], ctx)
            out = step(batch, gen) if kind == "eager" else fused(batch)
            losses.append(torch.stack(list(out)).clone())
            draws.append([dict(d) for d in step.draws])
        runs[kind] = losses, draws, _state(models, step)
        if kind == "fused":
            assert fused.stats() == {"graphs": False, "warmups": 0,
                                     "captures": [], "replays": 0}
    (le, de, se), (lf, df, sf) = runs["eager"], runs["fused"]
    for a, b in zip(de, df):
        assert len(a) == len(b) == 1
        assert sorted(a[0]) == ["keep", "noise", "times"]
        assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    for a, b in zip(le, lf):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=0)
    assert se.keys() == sf.keys()
    for k in se:
        torch.testing.assert_close(sf[k], se[k], rtol=0, atol=1e-6)
    assert int(sf["opt0.count"]) == 3 and int(sf["opt0.skipped"]) == 0


def test_fused_step_refuses_a_changed_shape():
    """A batch of another image size under a context size already seen
    raises: the static buffers are the first batch's."""
    models, step, gen = _setup()
    fused = FusedTrainStep(step, gen)
    _, scenes = _scenes(1)
    fused(_batch(scenes[0], [1, 2]))
    small = _batch(scenes[0], [1, 2])
    small["query_rgb"] = small["query_rgb"][:, :32]
    with pytest.raises(ValueError, match="shapes changed"):
        fused(small)


def test_device_guard_matches_optax_and_a_skipped_step():
    """Five steps of gradients, a NaN in the third: the device guard
    (``step_on_device`` on ``nonfinite_flag``) against optax's guarded
    Adam with its staircase (parameters within 1e-6, one skip counted)
    and against the same optimizer given the four finite steps only
    (bit-equal parameters, moments, Adam's step and staircase)."""
    cfg = trainer.TrainConfig(lr=1e-2, lr_decay_step=2, lr_decay_gamma=0.5)
    rng = np.random.RandomState(0)
    shapes = {"a": (5, 7), "b": (3,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for i in range(5):
        g = {k: rng.randn(*s).astype(np.float32) * 10.0 ** -i
             for k, s in shapes.items()}
        if i == 2:
            g["b"][1] = np.nan
        grads.append(g)
    tx, _ = jtrainer.make_optimizers(cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)

    def port(steps):
        tparams = {k: torch.nn.Parameter(torch.tensor(v))
                   for k, v in params.items()}
        opt = trainer.GuardedAdam(tparams.values(), cfg.lr, cfg)
        for g in steps:
            opt.zero_grad()
            for k, p in tparams.items():
                p.grad = torch.tensor(g[k])
            opt.step_on_device(opt.nonfinite_flag())
        return tparams, opt

    guarded, opt = port(grads)
    skipped, ref = port(grads[:2] + grads[3:])
    for g in grads:
        updates, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for k in shapes:
        np.testing.assert_allclose(guarded[k].detach().numpy(),
                                   np.asarray(jparams[k]), atol=1e-6, rtol=0)
        assert torch.equal(guarded[k], skipped[k]), k
        mine, theirs = opt.adam.state[guarded[k]], ref.adam.state[skipped[k]]
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(mine[key], theirs[key]), (k, key)
        assert float(mine["step"]) == 4
    assert opt.notfinite == jtrainer.notfinite_count(jstate) == 1
    assert ref.notfinite == 0
    assert opt.schedule.last_epoch == ref.schedule.last_epoch == 4
    assert torch.equal(opt.schedule.lrs[0], ref.schedule.lrs[0])
    assert float(opt.schedule.lrs[0]) == pytest.approx(cfg.lr * 0.25)
    assert opt.adam.param_groups[0]["lr"] is opt.schedule.lrs[0]


def _run(kinds, scenes, ckpt_path=None):
    """Steps of the given kinds ("eager" or "fused") on CONTEXTS; with
    ``ckpt_path`` a checkpoint after all but the last step, restored into
    new models, optimizers and generator for the last."""
    models, step, gen = _setup()
    for i, (kind, ctx) in enumerate(zip(kinds, CONTEXTS)):
        if ckpt_path is not None and i == len(kinds) - 1:
            save_checkpoint(ckpt_path, {
                "unet": models.unet.state_dict(),
                "eft": models.eft.state_dict(),
                "opts": [opt.state_dict() for opt in step.opts],
                "torch": gen.get_state()})
            models, step, gen = _setup(seed=99)
            ckpt = restore_checkpoint(ckpt_path)
            models.unet.load_state_dict(ckpt["unet"])
            models.eft.load_state_dict(ckpt["eft"])
            for opt, state in zip(step.opts, ckpt["opts"]):
                opt.load_state_dict(state)
            gen.set_state(ckpt["torch"])
        if kind == "fused":
            FusedTrainStep(step, gen)(_batch(scenes[0], ctx))
        else:
            step(_batch(scenes[0], ctx, host_range=True), gen)
    return _state(models, step)


@pytest.mark.parametrize("kinds", [("fused", "fused", "eager"),
                                   ("eager", "eager", "fused")],
                         ids=["graph_to_eager", "eager_to_graph"])
def test_checkpoint_round_trip_between_the_steps(tmp_path, kinds):
    """A checkpoint written after two steps of one kind and resumed by a
    step of the other continues exactly as the run without the round
    trip: parameters, moments, Adam's step (a tensor), the staircase and
    the guard's count, and the generator's draws."""
    _, scenes = _scenes(1)
    whole = _run(kinds, scenes)
    resumed = _run(kinds, scenes, str(tmp_path / "ckpt"))
    assert whole.keys() == resumed.keys()
    for k in whole:
        assert torch.equal(whole[k], resumed[k]), k
    assert int(resumed["opt0.count"]) == 3


TINY = ["-c", "any", "-d", "synthetic", "--preset", "tiny",
        "--image_size", "64", "--context_size", "2",
        "--diffusion_batch_size", "2", "--vis_itr", "0", "--device", "cpu"]


def test_cli_reads_losses_at_the_cadence(tmp_path, monkeypatch, capsys):
    """Reads at step 0 (every 50), at the checkpoint after step 2 and at
    the end (``loss_read`` spans, recorded under ``--spans``, after 1, 3
    and 5 steps); every step's loss returned; the step stays eager on the
    CPU.  ``--spans`` prints the operator's lines and writes the spans."""
    reads = []
    original = LossRing.read

    def read(ring):
        rows = original(ring)
        reads.append(len(rows))
        return rows

    monkeypatch.setattr(LossRing, "read", read)
    hooked = []
    r = train_cli.main(TINY + ["--exp_dir", str(tmp_path), "--steps", "5",
                               "--save_itr", "2", "--spans"],
                       step_hook=hooked.append)
    assert hooked == [0, 1, 2, 3, 4]
    assert reads == [1, 2, 2]
    steps = [s for s in r["spans"] if s["name"] == "train/step"]
    loss_reads = [s for s in r["spans"] if s["name"] == "loss_read"]
    assert [s["unit"] for s in steps] == [0, 1, 2, 3, 4]
    assert [sum(s["t1"] <= read["t0"] for s in steps)
            for read in loss_reads] == [1, 3, 5]
    assert steps[0]["t0"] <= loss_reads[0]["t1"]
    # at steps 2 and 4 and at the end
    assert sum(s["name"] == "checkpoint" for s in r["spans"]) == 3
    out = capsys.readouterr().out
    assert out.count("spans: ") == 3 and "x train/step; host " in out
    assert "spans set-up: checkpoint " in out
    with open(tmp_path / "spans_0.json") as f:
        dumped = json.load(f)
    assert [s["id"] for s in dumped["spans"]] == [s["id"]
                                                  for s in r["spans"]]
    assert len(r["losses"]) == len(r["d_losses"]) == 5
    assert np.isfinite(r["losses"]).all() and r["fused"] is None
    np.testing.assert_allclose(
        r["losses"], np.add(r["d_losses"], r["color_losses"]), rtol=1e-6)


def test_cli_debug_nans_runs(tmp_path):
    """``--debug_nans`` (anomaly mode, the eager step) still trains."""
    try:
        r = train_cli.main(TINY + ["--exp_dir", str(tmp_path), "--steps",
                                   "1", "--debug_nans"])
    finally:
        torch.autograd.set_detect_anomaly(False)
    assert len(r["losses"]) == 1 and np.isfinite(r["losses"]).all()
    assert r["notfinite"] == {"unet": 0, "eft": 0}


def test_loss_ring_grows_and_reads_in_order():
    ring = LossRing(3, "cpu", rows=2)
    for i in range(5):
        ring.push(torch.tensor([i, 2.0 * i, 3.0 * i]))
    assert ring.read() == [[i, 2.0 * i, 3.0 * i] for i in range(5)]
    assert ring.read() == [] and ring.buf.shape == (8, 3)
