"""One rank of the port's multi-process checks (tests/test_torch_parallel_ranks.py,
which starts WORLD copies of it; pytest does not collect this file).

    python tests/torch_parallel_worker.py RANK WORLD STORE DATA MODEL INPUTS OUTDIR

Each rank joins a gloo process group through the FileStore at STORE, builds a
DATA × MODEL mesh of CPU ranks, runs every case of its launch and writes what
it measured to OUTDIR/rank{RANK}.pt. It imports no JAX: the JAX side of a
comparison comes in INPUTS (weights, batch and draws), written by the test.

Launch with MODEL 1 (data-parallel):
  a    the 'jit' trainer, 6 steps of each family: losses, first reduced grads
  b    MBM one step in 'jit' and 'shard_map' mode on INPUTS' weights and draws
  d    a NaN in one rank's rows under skip_nonfinite_updates, then predict
  e    bulk_sample over the data ranks
  f    the named-axis collectives over 'data', with and without gradients
Launch with MODEL > 1 (tensor-parallel):
  c    6 steps of each family with the Megatron pairs split, the shards'
       shapes, a checkpoint (written to OUTDIR) and a sample from the end state
"""

import copy
import datetime
import os
import sys

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from multimodal_particles_tpu_torch.config_classes import (  # noqa: E402
    AbsorbingConfig,
    MultimodalBridgeMatchingConfig,
    TransdimensionalEpicConfig,
)
from multimodal_particles_tpu_torch.data import (  # noqa: E402
    absorbing_training_batch,
    multiplicity_histogram,
    synthetic_training_batch,
    transdim_training_batch,
)
from multimodal_particles_tpu_torch.models.generative.absorbing.absorbing_flows import (  # noqa: E402
    AbsorbingFlow,
)
from multimodal_particles_tpu_torch.models.generative.init import init_parameters  # noqa: E402
from multimodal_particles_tpu_torch.models.generative.multimodal_bridge_matching import (  # noqa: E402
    MultiModalBridgeMatching,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional.transdimensional_model import (  # noqa: E402
    TransdimensionalJumpDiffusion,
)
from multimodal_particles_tpu_torch.parallel.bulk_sampling import bulk_sample  # noqa: E402
from multimodal_particles_tpu_torch.parallel.collectives import (  # noqa: E402
    all_gather_data,
    all_gather_data_grad,
    axis_index_data,
    pmean_data,
    ppermute_data,
    psum_data,
    psum_data_grad,
)
from multimodal_particles_tpu_torch.parallel.mesh import make_device_mesh, tree_map  # noqa: E402
from multimodal_particles_tpu_torch.training.trainer import Trainer  # noqa: E402
from multimodal_particles_tpu_torch.utils.experiment_files import ExperimentsFiles  # noqa: E402

FAMILIES = ("mbm", "absorbing", "transdimensional")
B, N, STEPS = 16, 16, 6
CONFIG_PATH = os.path.join(REPO, "tests", "resources", "configs_files", "config-mbm-test.yaml")
BULK_JETS, BULK_B = 40, 16
# the transdimensional network cut to one EPiC block and one 64-wide gsdm block
# of 2 heads: every Megatron pair still splits at model 2 (2 heads, 32 groups)
TRANSDIM_CUT = {"num_blocks": 1, "n_attn_blocks": 1, "transformer_dim": 64, "n_heads": 2}


def tiny_family(family, model_axis=1):
    """(model, config, global batch) of a family at B jets of N slots, 5
    sampler steps; the batch from a fixed seed."""
    gen = torch.Generator().manual_seed(3)
    if family == "mbm":
        cfg = MultimodalBridgeMatchingConfig.from_yaml(CONFIG_PATH)
        cfg.bridge.num_timesteps = 5
        batch, cls = synthetic_training_batch(B, N, 3, 8, gen), MultiModalBridgeMatching
    elif family == "absorbing":
        cfg = AbsorbingConfig()
        cfg.bridge.num_timesteps = 5
        batch, cls = absorbing_training_batch(B, N, 3, 8, gen), AbsorbingFlow
    else:
        cfg = TransdimensionalEpicConfig()
        cfg.sampler_kwargs.dt = 0.2
        for name, value in TRANSDIM_CUT.items():
            setattr(cfg.encoder, name, value)
        batch, cls = transdim_training_batch(B, N, 3, 8, gen), TransdimensionalJumpDiffusion
        cfg.data.target_info = {"hist_num_particles": multiplicity_histogram(batch[0])}
    cfg.data.batch_size, cfg.data.max_num_particles = B, N
    cfg.parallel.model_axis = model_axis
    return cls(cfg), cfg, batch


def run_steps(model, cfg, batch, mesh=None, steps=STEPS, files=None):
    """A trainer set up from seed 0 and `steps` train steps on `batch`:
    (trainer, per-step losses, the first step's reduced gradients, whole)."""
    trainer = Trainer(model, cfg, files, seed=0, mesh=mesh)
    trainer.setup()
    rows, _ = trainer.shard(batch)
    losses, grads = [], None
    for i in range(steps):
        losses.append(float(trainer.train_step(rows)["loss"]))
        if i == 0:
            grads = {k: trainer.whole(k, p.grad).clone() for k, p in trainer.state.params.items()}
    return trainer, losses, grads


def sample(model, family, batch):
    """The model's sample from `batch` with generator seed 11: the final
    continuous state (and the multiplicities of the transdimensional one)."""
    out = model.predict(batch, generator=torch.Generator().manual_seed(11))
    dims = getattr(out, "dims", None)
    return {"continuous": out.continuous.clone(), "dims": None if dims is None else dims.clone()}


def case_a(mesh):
    out = {}
    for family in FAMILIES:
        _, losses, grads = run_steps(*tiny_family(family), mesh=mesh)
        out[family] = {"losses": losses, "grads": grads}
    return out


def case_b(mesh, inputs):
    """One MBM step on INPUTS' weights in both modes, the draws of this
    rank's rows: the global batch's for 'jit', this shard's own for
    'shard_map'."""
    out = {}
    for mode in ("jit", "shard_map"):
        cfg = copy.deepcopy(inputs["config"])
        cfg.parallel.spmd_mode = mode
        trainer = Trainer(MultiModalBridgeMatching(cfg), cfg, seed=0, mesh=mesh)
        trainer.setup()
        trainer.copy_params(inputs["state_dict"])
        rows, _ = trainer.shard(inputs["batch"])
        r = mesh.get_local_rank("data")
        if mode == "jit":
            b = rows.source_continuous.shape[0]
            draws = tuple(d[r * b:(r + 1) * b] for d in inputs["draws"])
        else:
            draws = inputs["shard_draws"][r]
        out[mode] = float(trainer.train_step(rows, draws)["loss"])
    return out


def case_d(mesh):
    """Step 1 on a clean batch, step 2 with NaN kinematics in the rows of the
    last data rank only."""
    model, cfg, batch = tiny_family("mbm")
    cfg.parallel.skip_nonfinite_updates = True
    trainer = Trainer(model, cfg, seed=0, mesh=mesh)
    trainer.setup()
    first = trainer.train_step(trainer.shard(batch)[0])
    before = {k: p.detach().clone() for k, p in trainer.state.params.items()}
    bad = copy.deepcopy(batch)
    bad.target_continuous[B - B // mesh.size(0):] = float("nan")
    second = trainer.train_step(trainer.shard(bad)[0])
    # predict on 15 jets: padded to 16, 8 rows a rank, gathered, the pad dropped
    odd = tree_map(lambda x: x[:B - 1], batch)
    state = trainer.predict([odd], generator=torch.Generator().manual_seed(11))[0]
    return {"first_nonfinite": float(first["nonfinite_grads"]),
            "nonfinite": float(second["nonfinite_grads"]),
            "unchanged": all(torch.equal(p, before[k]) for k, p in trainer.state.params.items()),
            "count": trainer.state.opt_state.count, "predicted": state.continuous.clone()}


def case_e(mesh):
    model, cfg, _ = tiny_family("mbm")
    init_parameters(model, 0)
    result, stats = bulk_sample(model.eval(), cfg, BULK_JETS, batch_size=BULK_B, seed=0, mesh=mesh)
    return {"result": result, "stats": stats}


def case_f(mesh):
    """Each collective on x = [r + 1, 10 (r + 1)] of data rank r."""
    r = axis_index_data(mesh)
    x = torch.tensor([r + 1.0, 10.0 * (r + 1)], requires_grad=True)
    summed = psum_data_grad(x, mesh)
    (summed * torch.tensor([1.0, 2.0])).sum().backward()  # each rank's own loss
    grad_psum = x.grad.clone()
    x.grad = None
    gathered = all_gather_data_grad(x, mesh)
    (gathered * torch.arange(1.0, 1.0 + gathered.numel())).sum().backward()
    ring = [(i, (i + 1) % mesh.size(0)) for i in range(mesh.size(0))]
    return {"index": r, "psum": psum_data(x, mesh), "pmean": pmean_data(x, mesh),
            "all_gather": all_gather_data(x.detach(), mesh),
            "ppermute": ppermute_data(x.detach(), mesh, ring),
            "psum_grad": grad_psum, "all_gather_grad": x.grad.clone()}


def case_c(mesh, outdir):
    out = {}
    for family in FAMILIES:
        model, cfg, batch = tiny_family(family, model_axis=mesh.size(1))
        files = ExperimentsFiles(experiment_dir=os.path.join(outdir, f"ckpt_{family}"))
        trainer, losses, grads = run_steps(model, cfg, batch, mesh=mesh, files=files)
        params = trainer.state.params
        moments = {name: tuple(trainer.state.opt_state.inner.state[p]["exp_avg"].shape)
                   for name, p in params.items() if name in trainer.tp_dims}
        trainer.save_checkpoint("last")
        out[family] = {
            "losses": losses, "grads": grads, "tp_dims": dict(trainer.tp_dims),
            "shard_shapes": {k: tuple(params[k].shape) for k in trainer.tp_dims},
            "moment_shapes": moments,
            "checkpoint": files.get_checkpoint_path("last"),
            "sample": sample(model.eval(), family, batch),
        }
    return out


def main():
    rank, world, store, data, model_axis, inputs, outdir = sys.argv[1:8]
    rank, world, data, model_axis = int(rank), int(world), int(data), int(model_axis)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    mesh = make_device_mesh(data_axis=data, model_axis=model_axis, device_type="cpu")
    if model_axis == 1:
        out = {"a": case_a(mesh), "b": case_b(mesh, torch.load(inputs, weights_only=False)),
               "d": case_d(mesh), "e": case_e(mesh), "f": case_f(mesh)}
    else:
        out = {"c": case_c(mesh, outdir)}
    out["mesh"] = {"data": mesh.size(0), "model": mesh.size(1),
                   "coordinate": [mesh.get_local_rank("data"), mesh.get_local_rank("model")]}
    torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
