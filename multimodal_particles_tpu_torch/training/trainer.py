"""Single-device trainer (counterpart of multimodal_particles_tpu/training/trainer.py:40-489).

  * AdamW/Adam with per-epoch cosine annealing, after global-norm gradient
    clipping in optax's form (`ClippedOptimizer`, built from the config's
    train section as `build_optimizer` builds it, trainer.py:90-123);
  * EMA of the parameters and skipping of non-finite updates (:214-258);
  * best/last checkpoints on val_loss with `torch.save` (:394-464);
  * JSONL metrics with the JAX record fields (:346-355, :466-469), and to an
    active MLflow run when mlflow is installed (:470-483);
  * a torch.profiler window (`profile`).

The model is an `nn.Module` that owns its parameters and exposes
`loss_fn(batch, generator, draws) -> (loss, metrics)` and
`predict(batch, generator)`; bridge noise comes from the trainer's generator.
The transdimensional family's config tree has `optimizer_kwargs` where the
others have a `train` section: `resolve_train_config` synthesizes the one from
the other (:60-87), and its EMA decay comes from `ema_halflife_kimg`
(:142-149). Mesh, DDP and tensor parallelism are not ported.
"""

import contextlib
import dataclasses
import json
import math
import os
import time
from types import SimpleNamespace
from typing import Dict, Optional

import torch
from torch.profiler import record_function

from multimodal_particles_tpu_torch.models.generative.init import init_parameters


def cosine_annealing_schedule(lr: float, eta_min: float, t_max: int, steps_per_epoch: int):
    """Per-epoch CosineAnnealingLR (torch semantics: the argument is the epoch
    index, annealed over T_max epochs) as a function of the update count."""

    def schedule(step):
        epoch = step // max(steps_per_epoch, 1)
        cos = math.cos(math.pi * min(epoch, t_max) / t_max)
        return eta_min + (lr - eta_min) * (1.0 + cos) / 2.0

    return schedule


def resolve_train_config(config):
    """The `train` section of any family's config. The transdimensional tree
    carries `optimizer_kwargs` instead: Adam at its lr, betas and eps, the
    clip from `grad_conditioner_kwargs.grad_norm_clip`, no weight decay, no
    scheduler (trainer.py:60-87)."""
    train = getattr(config, "train", None)
    if train is not None:
        return train
    ok = config.optimizer_kwargs
    return SimpleNamespace(
        epochs=1,
        optimizer_name="AdamW" if "AdamW" in ok.class_name else "Adam",
        lr=ok.lr,
        betas=list(ok.betas),
        eps=ok.eps,
        weight_decay=0.0,
        gradient_clip_val=getattr(config.grad_conditioner_kwargs, "grad_norm_clip", 0.0),
        scheduler_name=None,
        scheduler_params={},
    )


def ema_decay_from_halflife(config):
    """EDM-style EMA: a half-life in thousands of samples
    (`ema_halflife_kimg`) → the decay a step of `batch_size` samples; None for
    a config without one (trainer.py:142-149)."""
    halflife = getattr(config, "ema_halflife_kimg", None)
    if not halflife:
        return None
    batch = getattr(config, "batch_size", None) or getattr(config.data, "batch_size", 64)
    return 0.5 ** (batch / (halflife * 1000.0))


class ClippedOptimizer:
    """optax.chain(clip_by_global_norm(c), adamw(schedule)) over one group of
    parameters. Weight decay applies to every parameter. The schedule is read
    at the count of applied updates before this one, so the first update uses
    lr(0); a skipped step does not advance the count."""

    def __init__(self, train_config, steps_per_epoch: int, params):
        params = list(params)
        sched = train_config.scheduler_params or {}
        if train_config.scheduler_name == "CosineAnnealingLR":
            self.schedule = cosine_annealing_schedule(
                train_config.lr, float(sched.get("eta_min", 0.0)),
                int(sched.get("T_max", 1000)), steps_per_epoch,
            )
        else:
            self.schedule = lambda step: train_config.lr
        name = (train_config.optimizer_name or "Adam").lower()
        betas = tuple(train_config.betas)
        if name == "adamw":
            self.inner = torch.optim.AdamW(params, lr=self.schedule(0), betas=betas,
                                           eps=train_config.eps,
                                           weight_decay=train_config.weight_decay)
        elif name == "adam":
            self.inner = torch.optim.Adam(params, lr=self.schedule(0), betas=betas,
                                          eps=train_config.eps)
        else:
            raise ValueError(f"unsupported optimizer {train_config.optimizer_name!r}")
        self.params = params
        self.clip = float(train_config.gradient_clip_val or 0.0)
        self.count = 0

    def clip_gradients(self):
        """optax.clip_by_global_norm: g ← (g / ‖g‖)·c when ‖g‖ ≥ c. (Not
        clip_grad_norm_, which divides by ‖g‖ + 1e-6.) Multi-tensor kernels:
        a few launches for all the gradients, not a few per gradient."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not self.clip or not grads:
            return
        norm = torch.nn.utils.get_total_norm(grads)
        torch._foreach_mul_(grads, torch.where(norm < self.clip, 1.0, self.clip / norm))

    def step(self):
        self.clip_gradients()
        for group in self.inner.param_groups:
            group["lr"] = self.schedule(self.count)
        self.inner.step()
        self.count += 1

    def state_dict(self):
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, state):
        self.count = int(state["count"])
        self.inner.load_state_dict(state["inner"])


@dataclasses.dataclass
class TrainState:
    """The trainer's state (trainer.py:40-45): the step count, the model's
    parameters by name (live tensors of the module), the optimizer and the
    EMA copy of the parameters (None without EMA)."""

    step: int
    params: Dict[str, torch.nn.Parameter]
    opt_state: ClippedOptimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None


class Trainer:
    """Single-device trainer.

    Args:
      model: the model (an nn.Module on its device).
      config: full config tree (train and parallel sections used).
      experiment_files: any object with `checkpoint_path(tag)`,
        `get_checkpoint_path(tag)` and `metrics_file`, or None.
      seed: seeds the initial parameters and the bridge noise.
      ema_decay: EMA decay d (e ← d·e + (1−d)·p); None takes the config's
        `ema_halflife_kimg` where it has one, else no EMA.
    """

    def __init__(self, model, config, experiment_files=None, seed: int = 0, ema_decay=None):
        self.model = model
        self.config = config
        self.files = experiment_files
        self.ema_decay = ema_decay if ema_decay is not None else ema_decay_from_halflife(config)
        self.seed = seed
        par = getattr(config, "parallel", None)
        self.skip_nonfinite_updates = bool(getattr(par, "skip_nonfinite_updates", False))
        self.state: Optional[TrainState] = None
        self.generator: Optional[torch.Generator] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ------------------------------------------------------------- build

    def setup(self, steps_per_epoch: int = 1):
        """Initialize the parameters from the seed, the optimizer, the EMA
        copy and the noise generator."""
        init_parameters(self.model, self.seed)
        params = dict(self.model.named_parameters())
        opt = ClippedOptimizer(resolve_train_config(self.config), steps_per_epoch, params.values())
        ema = ({k: p.detach().clone() for k, p in params.items()}
               if self.ema_decay is not None else None)
        self.state = TrainState(step=0, params=params, opt_state=opt, ema_params=ema)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        return self.state

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One update: loss and gradients, clip + optimizer (skipped when a
        gradient is non-finite and skip_nonfinite_updates is on), EMA. The
        metrics stay on the device."""
        state = self.state
        self.model.train()
        for p in state.params.values():
            p.grad = None
        loss, metrics = self.model.loss_fn(batch, self.generator, draws)
        with record_function("train.backward"):
            loss.backward()
        with record_function("train.optimizer"):
            if self.skip_nonfinite_updates:
                grads = [p.grad for p in state.params.values() if p.grad is not None]
                finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
                metrics = {**metrics, "nonfinite_grads": 1.0 - finite.float()}
                if bool(finite):
                    state.opt_state.step()
            else:
                state.opt_state.step()
        if state.ema_params is not None:
            d = self.ema_decay
            ema = [state.ema_params[name] for name in state.params]
            with torch.no_grad(), record_function("train.ema"):
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, list(state.params.values()), alpha=1.0 - d)
        state.step += 1
        return metrics

    @torch.no_grad()
    def eval_step(self, batch, epoch: int, batch_idx: int) -> Dict[str, torch.Tensor]:
        """Validation loss with bridge noise fixed by (epoch, batch index)."""
        self.model.eval()
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed + 7919 + batch_idx) * 1000003 + epoch)
        _, metrics = self.model.loss_fn(batch, gen)
        return metrics

    # -------------------------------------------------------------- loops

    def fit(self, datamodule, epochs: Optional[int] = None):
        """Training loop with validation, best/last checkpoints and JSONL
        metrics (trainer.py:300-362). Returns the per-epoch records."""
        epochs = epochs if epochs is not None else resolve_train_config(self.config).epochs
        steps_per_epoch = max(len(datamodule.train), 1)
        if self.state is None:
            self.setup(steps_per_epoch)

        best_val = math.inf
        history = []
        for epoch in range(epochs):
            t0 = time.time()
            train_metrics = [self.train_step(batch) for batch in datamodule.train]
            record_metrics = _epoch_means(train_metrics)
            train_loss = record_metrics.pop("loss", float("nan"))
            val_loss = None
            if datamodule.valid is not None:
                val = [float(self.eval_step(batch, epoch, i)["loss"])
                       for i, batch in enumerate(datamodule.valid)]
                val_loss = sum(val) / len(val) if val else None
            record = {
                "epoch": epoch,
                "step": int(self.state.step),
                "train_loss": train_loss,
                "val_loss": val_loss,
                "epoch_time_s": time.time() - t0,
                **{f"train_{k}": v for k, v in record_metrics.items()},
            }
            history.append(record)
            self._log_metrics(record)
            if self.files is not None:
                self.save_checkpoint("last")
                if val_loss is not None and val_loss < best_val:
                    best_val = val_loss
                    self.save_checkpoint("best")
        return history

    @torch.no_grad()
    def predict(self, datamodule_or_batches, generator=None, use_ema: bool = True):
        """Run the model's sampler over all (test/val) batches and return the
        final states, with the EMA parameters when EMA is on
        (trainer.py:364-390)."""
        batches = datamodule_or_batches
        if hasattr(batches, "test") or hasattr(batches, "valid"):
            batches = list(getattr(batches, "test", None) or batches.valid or batches.train)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self.seed + 2)
        self.model.eval()
        swap = use_ema and self.state.ema_params is not None
        if swap:
            saved = {k: p.detach().clone() for k, p in self.state.params.items()}
            self._copy_params(self.state.ema_params)
        try:
            return [self.model.predict(batch, generator=generator) for batch in batches]
        finally:
            if swap:
                self._copy_params(saved)

    def _copy_params(self, values: Dict[str, torch.Tensor]):
        with torch.no_grad():
            for name, p in self.state.params.items():
                p.copy_(values[name])

    # -------------------------------------------------------- check/metrics

    def save_checkpoint(self, tag: str):
        """torch.save of step, params, optimizer state and EMA into the
        directory `files.checkpoint_path(tag)`."""
        path = os.path.abspath(self.files.checkpoint_path(tag))
        os.makedirs(path, exist_ok=True)
        payload = {
            "step": self.state.step,
            "params": {k: p.detach().cpu().clone() for k, p in self.state.params.items()},
            "opt_state": self.state.opt_state.state_dict(),
        }
        if self.state.ema_params is not None:
            payload["ema_params"] = {k: v.cpu().clone() for k, v in self.state.ema_params.items()}
        tmp = os.path.join(path, "state.pt.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, "state.pt"))

    def load_checkpoint(self, tag_or_path: str):
        """Restore step, params, optimizer state and EMA from a checkpoint
        directory or a files tag ('best', 'last')."""
        path = (tag_or_path if os.path.isdir(tag_or_path)
                else self.files.get_checkpoint_path(tag_or_path))
        # on the CPU: the optimizer moves its moments to the parameters' device
        # and keeps its step counts on the host (on the device, AdamW would
        # read them back with a synchronizing .item() per tensor and step)
        payload = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                             weights_only=True)
        self._copy_params(payload["params"])
        self.state.opt_state.load_state_dict(payload["opt_state"])
        if "ema_params" in payload:
            self.state.ema_params = {k: v.to(self.device) for k, v in payload["ema_params"].items()}
        self.state.step = int(payload["step"])
        return self.state

    def _log_metrics(self, record: dict):
        if self.files is not None:
            with open(self.files.metrics_file, "a") as fh:
                fh.write(json.dumps(record) + "\n")
        # the record's numbers to the active MLflow run, when mlflow is installed
        # (trainer.py:470-483)
        try:
            import mlflow
        except ImportError:
            return
        if mlflow.active_run() is not None:
            mlflow.log_metrics({k: v for k, v in record.items() if isinstance(v, (int, float))},
                               step=record.get("step", 0))

    # ------------------------------------------------------------ profiling

    @contextlib.contextmanager
    def profile(self, log_dir: str):
        """torch.profiler window over the block (CPU, and CUDA when the model
        is on a card); writes `log_dir/trace.json` and yields the profiler."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _epoch_means(metrics_list):
    """Per-name means over an epoch's metric dicts, as floats; one host read
    per name."""
    if not metrics_list:
        return {}
    return {name: torch.stack([m[name].float() for m in metrics_list]).mean().item()
            for name in metrics_list[0]}
