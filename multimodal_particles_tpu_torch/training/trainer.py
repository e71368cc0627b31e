"""The trainer (counterpart of multimodal_particles_tpu/training/trainer.py:40-489),
on one device or data- and tensor-parallel over a ('data', 'model') mesh of
torch.distributed ranks:

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
(:142-149).

Parallelism (trainer.py:137-196, :270-293, :316-384, :426-455). The mesh
comes from `config.parallel` (`parallel/mesh.py::make_device_mesh`) unless one
is given; each rank reads the same global batches, pads them to a multiple of
the data axis and keeps its rows (`pad_to_multiple`, `shard_batch`). After
`backward` the gradients are all-reduced over 'data' in a few flat buckets
(not DDP: the trainer calls `model.loss_fn`, not the module's forward, so
DDP's reducer would never be prepared). `parallel.spmd_mode`:

  * "jit" (JAX's default): the loss of the global batch, as XLA computes it.
    Every draw is made for the global batch from a generator seeded alike on
    every rank, each rank keeps its rows, the normalisers are global and the
    ranks' shares of the loss sum to it (`parallel/spmd.py`); gradients and
    metrics are summed over 'data'. An R-rank run equals the one-process run
    from the same seed, up to the order of the sums.
  * "shard_map" (collectives.py:57-117): each rank's loss on its rows, with
    its generator seeded by (seed, data index); gradients and metrics are
    averaged over 'data'.

At `parallel.model_axis` > 1 the Megatron pairs go tensor-parallel
(`parallel/tp.py`; "shard_map" refuses it, as JAX does); the clip takes the
global norm (a split parameter's squares summed over 'model', a replicated
one counted once), AdamW and the EMA act on the local shards, and a
checkpoint holds the whole (gathered) parameters, so that it loads into a
trainer of any layout. Only rank 0 writes checkpoints, metrics and MLflow.
`parallel.donate_buffers` is read by the JAX trainer only (buffer donation
has no PyTorch counterpart). With no process group the mesh has one rank and
the trainer runs on its device alone, as before.
"""

import contextlib
import dataclasses
import json
import math
import os
import time
from types import SimpleNamespace
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from multimodal_particles_tpu_torch.models.generative.init import init_parameters
from multimodal_particles_tpu_torch.parallel import spmd
from multimodal_particles_tpu_torch.parallel.collectives import (
    all_gather_data,
    all_reduce_coalesced,
)
from multimodal_particles_tpu_torch.parallel.mesh import (
    LocalMesh,
    batch_size,
    make_device_mesh,
    mesh_shape,
    pad_to_multiple,
    shard_batch,
    tree_map,
)
from multimodal_particles_tpu_torch.parallel.tp import gather_full, local_block, shard_params_tp


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
    lr(0); a skipped step does not advance the count. Under tensor
    parallelism `sharded` names the parameters split over `model_group`."""

    def __init__(self, train_config, steps_per_epoch: int, params, sharded=(), model_group=None):
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
        self.sharded = {id(p) for p in sharded}
        self.model_group = model_group

    def clip_gradients(self):
        """optax.clip_by_global_norm: g ← (g / ‖g‖)·c when ‖g‖ ≥ c. (Not
        clip_grad_norm_, which divides by ‖g‖ + 1e-6.) Multi-tensor kernels:
        a few launches for all the gradients, not a few per gradient. Under
        tensor parallelism ‖g‖ is the whole model's: the split parameters'
        squares summed over the 'model' group, the replicated ones once."""
        grads = [p.grad for p in self.params if p.grad is not None]
        if not self.clip or not grads:
            return
        if self.model_group is None:
            norm = torch.nn.utils.get_total_norm(grads)
        else:
            split = [p.grad for p in self.params if p.grad is not None and id(p) in self.sharded]
            whole = [p.grad for p in self.params
                     if p.grad is not None and id(p) not in self.sharded]
            split_sq = (torch.nn.utils.get_total_norm(split) ** 2 if split
                        else grads[0].new_zeros(()))
            dist.all_reduce(split_sq, group=self.model_group)
            whole_sq = torch.nn.utils.get_total_norm(whole) ** 2 if whole else 0.0
            norm = torch.sqrt(split_sq + whole_sq)
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
    """Trainer on one device, or data- and tensor-parallel over a mesh.

    Args:
      model: the model (an nn.Module on this rank's device).
      config: full config tree (train and parallel sections used).
      experiment_files: any object with `checkpoint_path(tag)`,
        `get_checkpoint_path(tag)` and `metrics_file`, or None.
      seed: seeds the initial parameters and the bridge noise.
      ema_decay: EMA decay d (e ← d·e + (1−d)·p); None takes the config's
        `ema_halflife_kimg` where it has one, else no EMA.
      mesh: a ('data', 'model') mesh (`parallel/mesh.py`); None builds one
        from `config.parallel.data_axis` / `model_axis` over the process
        group's ranks (the one-rank mesh without a process group).
    """

    def __init__(self, model, config, experiment_files=None, seed: int = 0, ema_decay=None,
                 mesh=None):
        self.model = model
        self.config = config
        self.files = experiment_files
        self.ema_decay = ema_decay if ema_decay is not None else ema_decay_from_halflife(config)
        self.seed = seed
        par = getattr(config, "parallel", None)
        self.skip_nonfinite_updates = bool(getattr(par, "skip_nonfinite_updates", False))
        self.mesh = mesh if mesh is not None else make_device_mesh(
            data_axis=getattr(par, "data_axis", -1), model_axis=getattr(par, "model_axis", 1),
            device_type=self.device.type)
        shape = mesh_shape(self.mesh)
        self.data_parallel, self.model_parallel = shape["data"], shape["model"]
        if self.model_parallel > 1 and getattr(par, "model_axis", 1) != self.model_parallel:
            # the kernel gates read config.parallel.model_axis
            raise ValueError(f"the mesh's model axis is {self.model_parallel}; "
                             f"config.parallel.model_axis must say so")
        # 'jit': the global batch's loss; 'shard_map': each rank's, averaged
        self.spmd_mode = getattr(par, "spmd_mode", "jit") or "jit"
        if self.spmd_mode not in ("jit", "shard_map"):
            raise ValueError(f"unknown parallel.spmd_mode {self.spmd_mode!r}")
        self.distributed = not isinstance(self.mesh, LocalMesh)
        self.tp_dims: Dict[str, int] = {}
        self.state: Optional[TrainState] = None
        self.generator: Optional[torch.Generator] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def rank(self) -> int:
        """This process's rank in the process group (0 without one): rank 0
        writes the checkpoints and metrics."""
        return dist.get_rank() if dist.is_initialized() else 0

    def _group(self, axis):
        return self.mesh.get_group(axis) if self.distributed else None

    # ------------------------------------------------------------- build

    def setup(self, steps_per_epoch: int = 1):
        """Initialize the parameters from the seed (the same on every rank),
        put them in tensor-parallel form at model_axis > 1, build the
        optimizer, the EMA copy and the noise generator."""
        init_parameters(self.model, self.seed)
        if self.model_parallel > 1:
            if self.spmd_mode == "shard_map":
                raise ValueError(
                    "spmd_mode='shard_map' is the explicit data-parallel formulation "
                    "(it replicates the parameters); tensor parallelism "
                    "(parallel.model_axis > 1) requires spmd_mode='jit'")
            self.tp_dims = shard_params_tp(self.model, self.mesh)
        params = dict(self.model.named_parameters())
        opt = ClippedOptimizer(resolve_train_config(self.config), steps_per_epoch, params.values(),
                               sharded=[params[k] for k in self.tp_dims],
                               model_group=self._group("model") if self.tp_dims else None)
        ema = ({k: p.detach().clone() for k, p in params.items()}
               if self.ema_decay is not None else None)
        self.state = TrainState(step=0, params=params, opt_state=opt, ema_params=ema)
        seed = self.seed + 1
        if self.spmd_mode == "shard_map" and self.data_parallel > 1:
            # each rank's own draws, as JAX folds in axis_index (collectives.py:68-69)
            seed = _folded_seed(seed, self.mesh.get_local_rank("data"))
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        return self.state

    def _global_batch(self, batch) -> Optional[spmd.GlobalBatch]:
        """The 'jit' semantics of this rank's rows of the global batch."""
        if self.data_parallel == 1:
            return None
        b = batch_size(batch)
        r = self.mesh.get_local_rank("data")
        return spmd.GlobalBatch(rows=slice(r * b, (r + 1) * b), size=b * self.data_parallel,
                                group=self._group("data"), first=r == 0)

    def _reduce_metrics(self, metrics, mode: str):
        """The metrics over 'data': summed shares ('jit', extremes by the
        model's `metric_reductions`) or averaged ('shard_map')."""
        group = self._group("data")
        if group is None:
            return metrics
        ops = getattr(self.model, "metric_reductions", {}) if mode == "jit" else {}
        out = dict(metrics)
        for op in ("sum", "max", "min"):
            names = [k for k in metrics if ops.get(k, "sum") == op]
            if not names:
                continue
            values = torch.stack([torch.as_tensor(metrics[k], device=self.device).float()
                                  for k in names])
            dist.all_reduce(values, op=_REDUCE_OPS[op], group=group)
            if mode == "shard_map":
                values = values / self.data_parallel
            out.update(zip(names, values.unbind()))
        return out

    def train_step(self, batch, draws=None) -> Dict[str, torch.Tensor]:
        """One update on this rank's rows of a global batch (the whole batch
        on one rank): loss and gradients, their reduction over 'data', clip +
        optimizer (skipped when a reduced gradient is non-finite and
        skip_nonfinite_updates is on, on every rank alike), EMA. `draws`
        replaces the bridge draws of this rank's rows. The metrics stay on
        the device."""
        state = self.state
        self.model.train()
        for p in state.params.values():
            p.grad = None
        jit = self.spmd_mode == "jit"
        with spmd.global_batch(self._global_batch(batch) if jit else None):
            loss, metrics = self.model.loss_fn(batch, self.generator, draws)
        with record_function("train.backward"):
            loss.backward()
        if self.distributed:
            with record_function("train.reduce"):
                grads = [p.grad for p in state.params.values() if p.grad is not None]
                all_reduce_coalesced(grads, self._group("data"))
                if not jit:
                    torch._foreach_div_(grads, self.data_parallel)
                metrics = self._reduce_metrics(metrics, self.spmd_mode)
        with record_function("train.optimizer"):
            if self.skip_nonfinite_updates:
                grads = [p.grad for p in state.params.values() if p.grad is not None]
                finite = torch.stack([torch.isfinite(g).all() for g in grads]).all().float()
                if self.tp_dims:  # a split gradient's shard lives on one rank of the pair
                    dist.all_reduce(finite, op=dist.ReduceOp.MIN, group=self._group("model"))
                metrics = {**metrics, "nonfinite_grads": 1.0 - finite}
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
        """Validation loss with bridge noise fixed by (epoch, batch index), of
        the global batch in either mode (JAX's eval step is always jitted)."""
        self.model.eval()
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed + 7919 + batch_idx) * 1000003 + epoch)
        with spmd.global_batch(self._global_batch(batch)):
            _, metrics = self.model.loss_fn(batch, gen)
        return self._reduce_metrics(metrics, "jit")

    def shard(self, batch):
        """This rank's rows of a global batch, padded to a multiple of the data
        axis by repeating its last sample (trainer.py:316-330); the batch as
        it is on a one-rank data axis. Returns (rows, the global batch's
        size before padding)."""
        if self.data_parallel == 1:
            return batch, batch_size(batch)
        batch, size = pad_to_multiple(batch, self.data_parallel)
        return shard_batch(batch, self.mesh, self.device), size

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
            train_metrics = [self.train_step(self.shard(batch)[0]) for batch in datamodule.train]
            record_metrics = _epoch_means(train_metrics)
            train_loss = record_metrics.pop("loss", float("nan"))
            val_loss = None
            if datamodule.valid is not None:
                val = [float(self.eval_step(self.shard(batch)[0], epoch, i)["loss"])
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
        (trainer.py:364-390). Over a data axis each rank samples its rows,
        from a generator seeded by (seed, data index) unless one is given;
        every rank returns the gathered states, the padding dropped."""
        batches = datamodule_or_batches
        if hasattr(batches, "test") or hasattr(batches, "valid"):
            batches = list(getattr(batches, "test", None) or batches.valid or batches.train)
        if generator is None:
            seed = self.seed + 2
            if self.data_parallel > 1:
                seed = _folded_seed(seed, self.mesh.get_local_rank("data"))
            generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model.eval()
        swap = use_ema and self.state.ema_params is not None
        if swap:
            saved = {k: p.detach().clone() for k, p in self.state.params.items()}
            self.copy_params(self.state.ema_params)
        try:
            outs = []
            for batch in batches:
                rows, size = self.shard(batch)
                out = self.model.predict(rows, generator=generator)
                if self.data_parallel > 1:
                    local = batch_size(rows)
                    out = tree_map(lambda x: all_gather_data(x, self.mesh)[:size]
                                   if torch.is_tensor(x) and x.dim() and x.shape[0] == local
                                   else x, out)
                outs.append(out)
            return outs
        finally:
            if swap:
                self.copy_params(saved)

    def copy_params(self, values: Dict[str, torch.Tensor]):
        """Copy values by name into the live parameters: this rank's block of
        a whole (gathered) value for a tensor-parallel parameter."""
        with torch.no_grad():
            for name, p in self.state.params.items():
                p.copy_(self.local(name, values[name]))

    def local(self, name, value):
        """This rank's block of a parameter's whole value (the value itself
        when it already has the parameter's shape)."""
        if name in self.tp_dims and value.shape != self.state.params[name].shape:
            return local_block(value, self.tp_dims[name], self.mesh.get_local_rank("model"),
                               self.model_parallel)
        return value

    def whole(self, name, value):
        """A parameter's whole value from this rank's block of it."""
        if name not in self.tp_dims:
            return value
        return gather_full(value, self.tp_dims[name], self._group("model"), self.model_parallel)

    def _moments(self, opt_state, convert):
        """The optimizer's state dict with `convert(name, moment)` applied to
        each parameter's moments (the inner optimizer keys them by position)."""
        names = list(self.state.params)
        inner = opt_state["inner"]
        return {**opt_state, "inner": {**inner, "state": {
            i: {k: convert(names[i], v) if torch.is_tensor(v) and v.dim() else v
                for k, v in st.items()} for i, st in inner["state"].items()}}}

    # -------------------------------------------------------- check/metrics

    def save_checkpoint(self, tag: str):
        """torch.save of step, params, optimizer state and EMA into the
        directory `files.checkpoint_path(tag)`, the whole (gathered) tensors
        under tensor parallelism; every rank takes part, rank 0 writes."""
        payload = {
            "step": self.state.step,
            "params": {k: self.whole(k, p.detach()).cpu().clone()
                       for k, p in self.state.params.items()},
            "opt_state": self._moments(self.state.opt_state.state_dict(),
                                       lambda k, v: self.whole(k, v).cpu()),
        }
        if self.state.ema_params is not None:
            payload["ema_params"] = {k: self.whole(k, v).cpu().clone()
                                     for k, v in self.state.ema_params.items()}
        if self.rank == 0:
            path = os.path.abspath(self.files.checkpoint_path(tag))
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, "state.pt.tmp")
            torch.save(payload, tmp)
            os.replace(tmp, os.path.join(path, "state.pt"))
        if self.distributed:
            dist.barrier()

    def load_checkpoint(self, tag_or_path: str):
        """Restore step, params, optimizer state and EMA from a checkpoint
        directory or a files tag ('best', 'last'), whichever layout saved it:
        under tensor parallelism each rank takes its blocks."""
        path = (tag_or_path if os.path.isdir(tag_or_path)
                else self.files.get_checkpoint_path(tag_or_path))
        # on the CPU: the optimizer moves its moments to the parameters' device
        # and keeps its step counts on the host (on the device, AdamW would
        # read them back with a synchronizing .item() per tensor and step)
        payload = torch.load(os.path.join(path, "state.pt"), map_location="cpu",
                             weights_only=True)
        self.copy_params(payload["params"])
        self.state.opt_state.load_state_dict(self._moments(payload["opt_state"], self.local))
        if "ema_params" in payload:
            self.state.ema_params = {k: self.local(k, v).to(self.device)
                                     for k, v in payload["ema_params"].items()}
        self.state.step = int(payload["step"])
        return self.state

    def _log_metrics(self, record: dict):
        if self.rank != 0:
            return
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


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def _folded_seed(seed: int, index: int) -> int:
    """A generator seed from (seed, index), as jax.random.fold_in derives a key."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


def _epoch_means(metrics_list):
    """Per-name means over an epoch's metric dicts, as floats; one host read
    per name."""
    if not metrics_list:
        return {}
    return {name: torch.stack([m[name].float() for m in metrics_list]).mean().item()
            for name in metrics_list[0]}
