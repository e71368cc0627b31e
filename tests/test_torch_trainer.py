"""The port's Trainer on the CPU: loss goes down, checkpoints round-trip
exactly, EMA follows its closed form, non-finite updates are skipped, `fit`
writes the JAX trainer's JSONL record fields, `predict` samples with the EMA
weights; the synthetic training data and the train config section; and the
compute_dtype repair (the port refuses what it would silently ignore)."""

import json
import os

import numpy as np
import pytest
import torch

from multimodal_particles_tpu_torch.config_classes import MultimodalBridgeMatchingConfig
from multimodal_particles_tpu_torch.data import InMemoryDataModule, synthetic_training_batch
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.training.trainer import Trainer
from multimodal_particles_tpu_torch.utils.experiment_files import ExperimentsFiles
from torch_port_helpers import jax_config

B, N = 16, 16
JAX_RECORD_FIELDS = {"epoch", "step", "train_loss", "val_loss", "epoch_time_s",
                     "train_loss_continuous", "train_loss_discrete"}


def tiny_config(**parallel):
    cfg = MultimodalBridgeMatchingConfig()
    cfg.data.max_num_particles = N
    cfg.bridge.num_timesteps = 5
    for name, value in parallel.items():
        setattr(cfg.parallel, name, value)
    return cfg


def batch(seed=0, num_empty=1):
    return synthetic_training_batch(B, N, 3, 8, torch.Generator().manual_seed(seed),
                                    num_empty=num_empty)


def fixed_draws(seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((B,), generator=gen), torch.randn((B, N, 3), generator=gen), torch.rand(
        (B, N), generator=gen)


def make_trainer(tmp_path=None, seed=0, ema_decay=None, **parallel):
    cfg = tiny_config(**parallel)
    files = ExperimentsFiles(str(tmp_path / "run")) if tmp_path is not None else None
    trainer = Trainer(MultiModalBridgeMatching(cfg), cfg, files, seed=seed, ema_decay=ema_decay)
    trainer.setup()
    return trainer


def snapshot(trainer):
    return {k: p.detach().clone() for k, p in trainer.state.params.items()}


def test_steps_reduce_loss():
    trainer = make_trainer()
    data, draws = batch(), fixed_draws()
    losses = [trainer.train_step(data, draws)["loss"].item() for _ in range(12)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert trainer.state.step == 12 and trainer.state.opt_state.count == 12


def test_checkpoint_round_trip_is_exact(tmp_path):
    trainer = make_trainer(tmp_path, ema_decay=0.9)
    for _ in range(2):
        trainer.train_step(batch())
    trainer.save_checkpoint("best")
    params, opt = snapshot(trainer), trainer.state.opt_state.state_dict()

    other = make_trainer(tmp_path, seed=5, ema_decay=0.9)
    assert any(not torch.equal(p, params[k]) for k, p in other.state.params.items())
    other.load_checkpoint("best")
    assert other.state.step == 2
    for k, p in other.state.params.items():
        assert torch.equal(p, params[k]), k
        assert torch.equal(other.state.ema_params[k], trainer.state.ema_params[k]), k
    restored = other.state.opt_state.state_dict()
    assert restored["count"] == opt["count"] == 2
    for pid, state in opt["inner"]["state"].items():
        for name, value in state.items():
            assert torch.equal(restored["inner"]["state"][pid][name], value), (pid, name)
    with pytest.raises(FileNotFoundError):
        other.load_checkpoint("last")


def test_ema_follows_closed_form():
    d = 0.9
    trainer = make_trainer(ema_decay=d)
    p0 = snapshot(trainer)
    trainer.train_step(batch())
    p1 = snapshot(trainer)
    trainer.train_step(batch())
    p2 = snapshot(trainer)
    for k in p0:
        expect = d * d * p0[k] + d * (1 - d) * p1[k] + (1 - d) * p2[k]
        torch.testing.assert_close(trainer.state.ema_params[k], expect, atol=1e-6, rtol=1e-6)


def test_nonfinite_gradient_skips_the_update():
    trainer = make_trainer(skip_nonfinite_updates=True)
    trainer.train_step(batch())
    before, opt_before = snapshot(trainer), trainer.state.opt_state.state_dict()
    opt_before = {pid: {n: v.clone() for n, v in s.items()}
                  for pid, s in opt_before["inner"]["state"].items()}
    hook = trainer.model.loss_weights.register_hook(lambda g: g * float("inf"))
    metrics = trainer.train_step(batch(1))
    hook.remove()
    assert metrics["nonfinite_grads"].item() == 1.0
    assert trainer.state.opt_state.count == 1 and trainer.state.step == 2
    for k, p in trainer.state.params.items():
        assert torch.equal(p, before[k]), k
    after = trainer.state.opt_state.state_dict()["inner"]["state"]
    for pid, state in opt_before.items():
        for name, value in state.items():
            assert torch.equal(after[pid][name], value), (pid, name)
    metrics = trainer.train_step(batch(2))
    assert metrics["nonfinite_grads"].item() == 0.0 and trainer.state.opt_state.count == 2
    assert any(not torch.equal(p, before[k]) for k, p in trainer.state.params.items())


def test_fit_writes_jax_record_fields_and_checkpoints(tmp_path):
    trainer = make_trainer(tmp_path)
    dm = InMemoryDataModule(train=[batch(0), batch(1), batch(2)], valid=[batch(3)])
    history = trainer.fit(dm, epochs=2)
    with open(trainer.files.metrics_file) as fh:
        records = [json.loads(line) for line in fh]
    assert records == history and len(records) == 2
    for epoch, record in enumerate(records):
        assert set(record) == JAX_RECORD_FIELDS
        assert record["epoch"] == epoch and record["step"] == 3 * (epoch + 1)
        assert np.isfinite(record["train_loss"]) and np.isfinite(record["val_loss"])
    for tag in ("best", "last"):
        assert os.path.isfile(os.path.join(trainer.files.get_checkpoint_path(tag), "state.pt"))


def test_predict_uses_ema_weights_and_restores_params():
    trainer = make_trainer(ema_decay=0.5)
    for _ in range(2):
        trainer.train_step(batch())
    params = snapshot(trainer)
    request = batch(4)
    out = trainer.predict([request], generator=torch.Generator().manual_seed(0))[0]
    for k, p in trainer.state.params.items():
        assert torch.equal(p, params[k]), k
    with torch.no_grad():
        for k, p in trainer.state.params.items():
            p.copy_(trainer.state.ema_params[k])
    ref = trainer.model.predict(request, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(out.continuous, ref.continuous)
    assert torch.equal(out.discrete, ref.discrete)


def test_profile_writes_a_trace(tmp_path):
    trainer = make_trainer()
    with trainer.profile(str(tmp_path / "prof")) as prof:
        trainer.train_step(batch())
    assert os.path.isfile(tmp_path / "prof" / "trace.json")
    assert len(prof.key_averages()) > 0


def test_synthetic_training_batch():
    data = batch(num_empty=2)
    mask = data.source_mask
    assert torch.equal(mask, data.target_mask)
    assert data.target_continuous.shape == (B, N, 3) and data.target_discrete.shape == (B, N, 1)
    assert (data.target_continuous[mask[..., 0] == 0] == 0).all()
    assert (data.target_discrete[mask[..., 0] == 0] == 0).all()
    assert ((data.target_discrete >= 0) & (data.target_discrete < 8)).all()
    assert mask[-2:].sum() == 0 and (mask[:-2].sum(dim=(1, 2)) >= 1).all()
    again = batch(num_empty=2)
    assert torch.equal(again.target_continuous, data.target_continuous)
    assert len(InMemoryDataModule(train=[data, again]).train) == 2


def test_train_section_round_trips_from_the_jax_config():
    cfg = jax_config()
    port = MultimodalBridgeMatchingConfig.from_dict(cfg.to_dict())
    assert port.train.__dict__ == cfg.train.__dict__
    assert port.train.lr == 1e-3 and port.train.scheduler_name == "CosineAnnealingLR"


def test_schrodinger_bridge_model_trains_and_samples():
    """The Schrödinger continuous bridge: its drift target in the loss and
    its Euler–Maruyama step (normals from the generator) in predict."""
    cfg = tiny_config()
    cfg.bridge.continuous = "SchrodingerBridge"
    trainer = Trainer(MultiModalBridgeMatching(cfg), cfg)
    trainer.setup()
    metrics = trainer.train_step(batch())
    assert np.isfinite(metrics["loss"].item())
    out = trainer.predict([batch(5)], generator=torch.Generator().manual_seed(0))[0]
    assert torch.isfinite(out.continuous).all()


def test_non_float32_compute_dtype_raises():
    """An unknown dtype name raises as the JAX package's lookup does;
    "bfloat16" builds and trains (tests/test_torch_bf16.py holds it)."""
    with pytest.raises(KeyError, match="float16"):
        MultiModalBridgeMatching(tiny_config(compute_dtype="float16"))
    cfg = tiny_config(compute_dtype="bfloat16")
    trainer = Trainer(MultiModalBridgeMatching(cfg), cfg)
    trainer.setup()
    assert np.isfinite(trainer.train_step(batch())["loss"].item())
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
