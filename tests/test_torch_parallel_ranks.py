"""The port's data and tensor parallelism across processes: two launches of
tests/torch_parallel_worker.py on gloo CPU ranks, one of 2 ranks (data 2) and
one of 4 (data 2 × model 2), held against the one-process port and against
the JAX trainer on a 2-device data mesh.

  (a) 'jit' data parallelism equals the one-process global-batch run, for the
      three families: 6 steps of losses (rtol 2e-4, atol 1e-5, the bound of
      tests/test_parallel/test_tensor_parallel.py) and the first reduced
      gradient per leaf (|err| ≤ 1e-5·max|leaf| + 1e-4·|ref|);
  (b) MBM's 2-rank step equals JAX's: the 'jit' step JAX's Trainer on a
      2-device data mesh, the 'shard_map' step `make_shard_map_train_step`,
      both from transplanted weights and JAX's draws (rtol 1e-5);
  (c) tensor parallelism at model 2 equals the replicated run at the same
      bounds, the split parameters and their Adam moments have the shard's
      shape, and a tensor-parallel checkpoint loads into a one-process
      trainer that then samples the same;
  (d) a NaN in one rank's rows leaves every rank's parameters unchanged, with
      nonfinite_grads 1.0 everywhere;
  (e) bulk_sample over 2 ranks;
  (f) the named-axis collectives over 'data', and the gradients of the
      gradient-carrying ones.

Every rank of a launch must end within LAUNCH_TIMEOUT seconds.
"""

import os
import re
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_particles_tpu.data.particle_clouds.jets_dataloader import JetsDataloaderModule
from multimodal_particles_tpu.models.generative.multimodal_bridge_matching import (
    MultiModalBridgeMatching as JaxMBM,
)
from multimodal_particles_tpu.parallel.mesh import make_device_mesh as jax_mesh
from multimodal_particles_tpu.parallel.mesh import shard_batch as jax_shard_batch
from multimodal_particles_tpu.training.trainer import Trainer as JaxTrainer
from multimodal_particles_tpu_torch.config_classes import MultimodalBridgeMatchingConfig
from multimodal_particles_tpu_torch.training.trainer import Trainer
from multimodal_particles_tpu_torch.utils.transplant import params_from_flax
from torch_parallel_worker import BULK_B, BULK_JETS, FAMILIES, N, run_steps, sample, tiny_family
from torch_port_helpers import (
    drawn_params,
    jax_config,
    noisy_params,
    port_batch,
)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
REPO = os.path.dirname(os.path.dirname(WORKER))
LAUNCH_TIMEOUT = 120
LOSS_RTOL, LOSS_ATOL = 2e-4, 1e-5
JAX_RTOL = 1e-5
# gradients that are 0 analytically (a softmax cancels a shift shared by all
# its logits): both runs hold rounding noise there, held against 0
ZERO_GRADIENT = re.compile(r"\.k\.bias$|near_atom_proj\.bias$")
ZERO_GRADIENT_ATOL = 1e-6


def _launch(world, data, model, inputs, outdir):
    os.makedirs(outdir)
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    return [subprocess.Popen([sys.executable, WORKER, str(r), str(world),
                              os.path.join(outdir, "store"), str(data), str(model), inputs, outdir],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]


def _finish(procs, outdir):
    """Every rank's record; a rank that fails or outlives the timeout fails
    the launch (the others are killed)."""
    try:
        logs = [p.communicate(timeout=LAUNCH_TIMEOUT)[0].decode(errors="replace") for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"a rank of {outdir} outlived {LAUNCH_TIMEOUT} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{log[-3000:]}"
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def _bridge_draws(key, batch):
    """The draws of the JAX MBM `sample_bridges` from `key`, as
    `torch_port_helpers.jax_bridge_draws` replays them, traceable."""
    key_t, key_x, key_k = jax.random.split(key, 3)
    x1 = batch.target_continuous
    return (jax.random.uniform(key_t, (x1.shape[0],), dtype=x1.dtype),
            jax.random.normal(key_x, x1.shape, dtype=x1.dtype),
            jax.random.uniform(key_k, x1.shape[:2], dtype=jnp.float32))


def _jax_inputs(path):
    """MBM at 8 jets: flax-shaped weights drawn by numpy plus noise, the
    port's transplant of them, JAX's draws of the first step (the global
    batch's for 'jit', each shard's for 'shard_map') and JAX's losses."""
    cfg = jax_config()
    batch = jax.tree_util.tree_map(jnp.asarray, JetsDataloaderModule.random_databatch(cfg))
    model = JaxMBM(cfg)
    params_np = noisy_params(drawn_params(model.init, jax.random.PRNGKey(0), batch), 0)
    torch_cfg = MultimodalBridgeMatchingConfig.from_dict(cfg.to_dict())
    key = jax.random.PRNGKey(7)
    b = batch.target_continuous.shape[0] // 2
    shards = [jax.tree_util.tree_map(lambda x: x[r * b:(r + 1) * b], batch) for r in range(2)]

    @jax.jit
    def draws(step_key):  # one program for the three sets of draws
        return (_bridge_draws(step_key, batch),
                [_bridge_draws(jax.random.fold_in(step_key, r), shards[r]) for r in range(2)])

    whole, per_shard = draws(jax.random.fold_in(key, 0))
    as_torch = lambda arrays: tuple(torch.tensor(np.asarray(a)) for a in arrays)  # noqa: E731
    torch.save({
        "config": torch_cfg,
        "state_dict": params_from_flax(params_np, torch_cfg),
        "batch": port_batch(batch),
        "draws": as_torch(whole),
        "shard_draws": [as_torch(d) for d in per_shard],
    }, path)
    return cfg, model, params_np, batch, key


def _jax_losses(cfg, model, params_np, batch, key):
    """The first step's loss of JAX's trainer on a 2-device data mesh, in
    both SPMD modes."""
    model.init = lambda *_: jax.tree_util.tree_map(jnp.asarray, params_np)  # fresh: donated
    mesh = jax_mesh(data_axis=2, model_axis=1)
    out = {}
    for mode in ("jit", "shard_map"):
        cfg.parallel.spmd_mode = mode
        trainer = JaxTrainer(model, cfg, mesh=mesh)
        trainer.setup(batch)
        _, metrics = trainer._train_step(trainer.state, key, jax_shard_batch(batch, mesh))
        out[mode] = float(metrics["loss"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks")
    inputs = str(root / "inputs.pt")
    jax_case = _jax_inputs(inputs)
    dp = _launch(2, 2, 1, inputs, str(root / "dp"))
    tp = _launch(4, 2, 2, inputs, str(root / "tp"))
    # the references while the ranks run: JAX's compiles in a thread beside the
    # port's one-process runs, these on one thread (tiny tensors: more threads
    # would only contend with the ranks)
    jax_losses, errors = {}, []

    def compile_jax():
        try:
            jax_losses.update(_jax_losses(*jax_case))
        except BaseException as e:  # re-raised below, in the test's thread
            errors.append(e)

    compiling = threading.Thread(target=compile_jax)
    compiling.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {f: run_steps(*tiny_family(f)) for f in FAMILIES}
    finally:
        torch.set_num_threads(threads)
        compiling.join()
    if errors:
        raise errors[0]
    return {"dp": _finish(dp, str(root / "dp")), "tp": _finish(tp, str(root / "tp")),
            "single": single, "jax": jax_losses}


def _assert_run_equals(got, ref):
    """6 steps of losses and the first step's reduced gradients."""
    _, losses, grads = ref
    np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert set(got["grads"]) == set(grads)
    for name, g in grads.items():
        err = (got["grads"][name] - g).abs()
        if ZERO_GRADIENT.search(name):
            assert got["grads"][name].abs().max() <= ZERO_GRADIENT_ATOL, name
            continue
        assert (err <= 1e-5 * g.abs().max() + 1e-4 * g.abs()).all(), (name, err.max())


@pytest.mark.parametrize("family", FAMILIES)
def test_jit_data_parallel_equals_one_process(runs, family):
    ranks = runs["dp"]
    assert [r["mesh"]["coordinate"] for r in ranks] == [[0, 0], [1, 0]]
    assert ranks[0]["a"][family]["losses"] == ranks[1]["a"][family]["losses"]
    _assert_run_equals(ranks[0]["a"][family], runs["single"][family])


@pytest.mark.parametrize("mode", ["jit", "shard_map"])
def test_mbm_two_ranks_equal_jax(runs, mode):
    got = [r["b"][mode] for r in runs["dp"]]
    assert got[0] == got[1]
    np.testing.assert_allclose(got[0], runs["jax"][mode], rtol=JAX_RTOL)


def test_spmd_modes_differ(runs):
    """The global batch's loss is not the mean of the shards' losses."""
    b = runs["dp"][0]["b"]
    assert abs(b["jit"] - b["shard_map"]) > 10 * JAX_RTOL * abs(b["jit"])


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_parallel_equals_replicated(runs, family):
    ranks = runs["tp"]
    assert [r["mesh"]["coordinate"] for r in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert all(r["c"][family]["losses"] == ranks[0]["c"][family]["losses"] for r in ranks)
    _assert_run_equals(ranks[0]["c"][family], runs["single"][family])


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_parallel_shards_and_moments(runs, family):
    got = runs["tp"][0]["c"][family]
    whole = dict(tiny_family(family)[0].named_parameters())
    dims = got["tp_dims"]
    assert any("fc_local1" in k for k in dims) and any("fc_global2" in k for k in dims)
    if family == "transdimensional":
        assert {"network.attn_0.q.weight", "network.vec_res_0.conv2.weight"} <= set(dims)
    for name, d in dims.items():
        shape = list(whole[name].shape)
        shape[d] //= 2
        assert got["shard_shapes"][name] == tuple(shape) == got["moment_shapes"][name]


@pytest.mark.parametrize("family", FAMILIES)
def test_tensor_parallel_checkpoint_into_one_process(runs, family):
    got = runs["tp"][0]["c"][family]
    model, cfg, batch = tiny_family(family)
    trainer = Trainer(model, cfg, seed=0)
    trainer.setup()
    trainer.load_checkpoint(got["checkpoint"])
    for name, p in trainer.state.params.items():
        assert p.shape == dict(tiny_family(family)[0].named_parameters())[name].shape
    out, ref = sample(model.eval(), family, batch), got["sample"]
    scale = 1.0 + ref["continuous"].abs().amax(dim=(1, 2), keepdim=True)
    assert ((out["continuous"] - ref["continuous"]).abs() <= 1e-4 * scale).all()
    if ref["dims"] is not None:
        assert torch.equal(out["dims"], ref["dims"])


def test_nonfinite_rows_on_one_rank_skip_everywhere(runs):
    for r in runs["dp"]:
        d = r["d"]
        assert d["first_nonfinite"] == 0.0 and d["nonfinite"] == 1.0
        assert d["unchanged"] and d["count"] == 1


def test_predict_gathers_the_ranks_rows_and_drops_the_padding(runs):
    """15 jets over 2 ranks: padded to 16, each rank samples its 8 rows with
    the generator given, every rank returns the same 15 gathered jets."""
    first, second = (r["d"]["predicted"] for r in runs["dp"])
    assert first.shape == (15, N, 3) and torch.isfinite(first).all()
    assert torch.equal(first, second)
    assert not torch.equal(first[:7], first[8:15])


def test_bulk_sample_over_two_ranks(runs):
    first, second = (r["e"] for r in runs["dp"])
    assert second["result"] is None
    result, stats = first["result"], first["stats"]
    assert stats["num_jets"] == BULK_JETS and stats["mesh"] == {"data": 2}
    assert stats["devices"] == 2 and second["stats"]["rank"] == 1
    assert first["stats"]["rank_jets"] + second["stats"]["rank_jets"] == BULK_JETS
    assert result["continuous"].shape == (BULK_JETS, N, 3)
    assert result["discrete"].shape == result["mask"].shape == (BULK_JETS, N, 1)
    assert np.isfinite(result["continuous"]).all()
    share = BULK_B // 2
    assert not np.array_equal(result["continuous"][:share], result["continuous"][share:BULK_B])


def test_data_axis_collectives(runs):
    """x = [r + 1, 10 (r + 1)] on data rank r: the sum, mean, gather and ring
    shift over 'data'; each rank's loss Σ c·psum(x) gives every rank the
    gradient Σ_ranks c, a loss on the gather gives each rank its own part's
    coefficients summed over the ranks."""
    x = [torch.tensor([r + 1.0, 10.0 * (r + 1)]) for r in range(2)]
    for r, record in enumerate(runs["dp"]):
        f = record["f"]
        assert f["index"] == r
        assert torch.equal(f["psum"], x[0] + x[1]) and torch.equal(f["pmean"], (x[0] + x[1]) / 2)
        assert torch.equal(f["all_gather"], torch.cat(x))
        assert torch.equal(f["ppermute"], x[1 - r])
        assert torch.equal(f["psum_grad"], torch.tensor([2.0, 4.0]))
        coefficients = torch.arange(1.0, 5.0).reshape(2, 2)
        assert torch.equal(f["all_gather_grad"], 2 * coefficients[r])
