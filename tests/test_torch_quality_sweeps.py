"""The port's head-to-head and sweep harnesses against the JAX system's
scripts on the CPU: scripts/torch_{quality_parity, quality_parity_absorbing,
quality_scaled_data, death_channel_sweep, transdim_operating_points,
diagnose_transdim}.py against quality_parity.py, quality_parity_absorbing.py,
quality_scaled_data.py, death_channel_sweep.py, transdim_operating_points.py
and diagnose_transdim.py.

The helpers each pair shares are held equal on the same numpy arrays: the
stress histograms, the `--points` parser and the score rows, `_epochs_for`
and `_widen_encoder`, the diagnostics rows and the forward marginal. Then all
six scripts run at a tiny size with `--device cpu` in one subprocess that
must not import JAX or the JAX package, and each writes every key of its JAX
counterpart's output.
"""

import json
import os
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import quality_scaled_data as jax_scaled  # noqa: E402
import torch_diagnose_transdim as diagnose  # noqa: E402
import torch_quality_parity_absorbing as parity_absorbing  # noqa: E402
import torch_quality_scaled_data as scaled  # noqa: E402
import torch_transdim_operating_points as points  # noqa: E402
import transdim_operating_points as jax_points  # noqa: E402

from multimodal_particles_tpu.models.generative.diffusion.noising import (  # noqa: E402
    get_forward_rate as jax_forward_rate,
)
from multimodal_particles_tpu_torch.models.generative.diffusion.noising import (  # noqa: E402
    get_forward_rate,
)

# the keys the JAX scripts write
PARITY_KEYS = {"protocol", "config", "train_steps", "sampler_steps", "gen_jets", "platform",
               "rebuilt", "reference", "ratio_rebuilt_over_reference"}  # quality_parity.py:285-311
PARITY_SIDE = {"final_train_loss", "final_val_loss", "train_wall_s", "gen_wall_s", "metrics"}
FEATURES = ("pt", "m", "eta", "phi", "multiplicity", "Q_total", "Q_jet", "tau21", "tau32", "d2")
ABSORBING_KEYS = {"protocol", "config", "epochs", "sampler_steps", "gen_jets", "stress_jets",
                  "target_dropout", "death_rate_scale", "platform", "seeds_done", "seeds",
                  "median_ratio_rebuilt_over_reference"}  # quality_parity_absorbing.py:414-438
ABSORBING_SEED = {"seed", "train_steps", "rebuilt", "reference", "ratio_rebuilt_over_reference",
                  "mask_dynamics_stress"}
STRESS = {"mult_mean_init", "mult_mean_final", "mult_mean_data", "KL_mult_init",
          "KL_mult_final", "dynamics_correct_init"}
DEATH_KEYS = {"protocol", "target_dropout", "scales", "platform", "seeds",
              "per_scale_summary"}  # death_channel_sweep.py:260-272, :295
DEATH_SUMMARY = {"uniform_KL_final", "uniform_corrects", "halved_KL_final", "halved_corrects",
                 "nominal_W1_multiplicity"}
SCALED_KEYS = {"family", "protocol", "data", "train_steps", "sampler_steps", "batch_size",
               "gen_jets", "platform", "seed", "rebuilt", "floors_at_this_scale",
               "ratio_to_floor_median"}  # quality_scaled_data.py:569-597
SCALED_EXTRA = {"mbm": set(), "absorbing": {"mask_dynamics"},
                "transdim": {"multi_birth", "multiplicity_dynamics"}}
POINT_ROW = {"sampler_steps", "multi_birth", "subprocess_wall_s", "gen_wall_s", "KL_mult",
             "W1_mult", "mult_mean_gen", "mult_mean_data", "diverged_constituent_frac",
             "physics_W1", "scored_jet_fraction"}  # transdim_operating_points.py:67-84
DIAG_COLUMNS = {"step", "t", "max_abs_x", "mean_dims", "fwd_marg", "births", "rate_mean"}


def feature_keys(features):
    return {f"{kind}_{f}" for f in features for kind in ("KL", "W1")}


# ----------------------------------------------------------- shared helpers


def test_stress_histograms_match_the_jax_script():
    """quality_parity_absorbing.py:327-331 (inline there): the data's
    multiplicity halved and clipped to [1, N], and uniform in [1, N] from
    default_rng(seed + 7)."""
    mult = np.random.default_rng(0).integers(1, 110, 100)
    for seed in (0, 3):
        rng = np.random.default_rng(seed + 7)
        ref = {"halved": np.clip(mult // 2, 1, 109),
               "uniform": rng.integers(1, 109 + 1, size=mult.shape)}
        got = parity_absorbing.stress_histograms(mult, 109, seed)
        assert got.keys() == ref.keys()
        for name in ref:
            np.testing.assert_array_equal(got[name], ref[name])


def test_points_parser_and_rows_match_the_jax_script(tmp_path, monkeypatch):
    """The JAX script's main parses --points and its run_point makes a row of
    the harness's JSON (written by a subprocess it launches, replaced here by
    one that writes a fixed document): the port's parser and rows give the
    same, but for the wall time."""
    grid, run_point = [], jax_points.run_point
    monkeypatch.setattr(jax_points, "run_point",
                        lambda steps, mb, args: grid.append((steps, mb)) or {})
    monkeypatch.setattr(sys, "argv", ["transdim_operating_points.py", "--points",
                                      " 96x16, 48x32,7x1", "--out", str(tmp_path / "rows.json")])
    jax_points.main()
    assert points.parse_points(" 96x16, 48x32,7x1") == grid == [(96, 16), (48, 32), (7, 1)]

    rng = np.random.default_rng(1)
    h = {"gen_wall_s": 3.5,
         "metrics": {k: float(rng.random()) for k in (
             "KL_mult_gen_vs_data", "W1_mult_gen_vs_data", "mult_mean_gen", "mult_mean_data",
             "diverged_constituent_frac")},
         "physics_metrics": {**{k: float(rng.random()) for k in points.PHYSICS_W1},
                             "W1_Q_jet": 1.0, "scored_jet_fraction": 0.99}}

    def fake_run(cmd, **kwargs):
        with open(cmd[cmd.index("--out") + 1], "w") as f:
            json.dump(h, f)
        return SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(jax_points.subprocess, "run", fake_run)
    ref = run_point(48, 24, SimpleNamespace(
        reuse_params="p", gen_jets=8, gen_chunk=8, seed=0, point_timeout=10.0))
    got = points.point_row(h, 48, 24, 1.0)
    assert got.keys() == ref.keys() == POINT_ROW
    assert {k: v for k, v in got.items() if k != "subprocess_wall_s"} == {
        k: v for k, v in ref.items() if k != "subprocess_wall_s"}


def test_epochs_and_widened_encoder_match_the_jax_script():
    for steps, spe in ((10000, 8), (6000, 16), (3, 5), (5, 0)):
        args = SimpleNamespace(train_steps=steps)
        assert scaled._epochs_for(args, spe) == jax_scaled._epochs_for(args, spe)
    ours, theirs = SimpleNamespace(), SimpleNamespace()
    scaled._widen_encoder(ours, 64, 4)
    jax_scaled._widen_encoder(theirs, 64, 4)
    assert vars(ours) == vars(theirs)


def test_diagnostics_rows_match_the_jax_script():
    """The table of diagnose_transdim.py:96-118 on the same diagnostics: the
    step lengths, the rows printed, and the forward marginal through each
    package's forward rate."""
    from scipy.stats import poisson

    rng = np.random.default_rng(2)
    T = 12
    ts = np.linspace(1.0, 1.0 / T, T).astype(np.float32)
    diag = {"ts": ts, "max_abs_x": rng.random(T) * 100, "mean_dims": np.linspace(1, 40, T),
            "birth_frac": rng.random(T), "rate_mean": rng.random(T) * 5}
    d0 = rng.integers(1, 64, 50)
    jax_rate = jax_forward_rate("step", 64, 0.1)

    def jax_fwd_marginal(t):  # diagnose_transdim.py:96-102
        lam = float(jax_rate.get_rate_integral(np.float32(t)))
        kmax = int(lam + 10 * np.sqrt(lam) + d0.max() + 10)
        k = np.arange(kmax + 1)
        pmf = poisson.pmf(k, lam)
        surv = np.clip(d0[:, None] - k[None, :], 1, None)
        return float((surv * pmf[None, :]).sum(axis=1).mean())

    dts = -np.diff(np.concatenate([diag["ts"], [0.0]]))  # :104
    ref = [(i, float(diag["ts"][i]), jax_fwd_marginal(max(diag["ts"][i] - dts[i], 0.0)))
           for i in list(range(0, T, 5)) + [T - 1]]
    rate = get_forward_rate("step", 64, 0.1)
    rows = diagnose.diagnostics_rows(diag, lambda t: diagnose.forward_marginal(rate, d0, t), 5)
    assert [r["step"] for r in rows] == [i for i, _, _ in ref] == [0, 5, 10, 11]
    for row, (i, t, fwd) in zip(rows, ref):
        assert row.keys() == DIAG_COLUMNS and row["t"] == t
        np.testing.assert_allclose(row["fwd_marg"], fwd, rtol=1e-6)
        assert row["births"] == diag["birth_frac"][i]
    summary = diagnose.final_summary(np.zeros((4, 8, 3)), np.array([1, 2, 3, 8]), diag)
    assert summary["realized_births_per_jet"] == pytest.approx(diag["birth_frac"].sum())
    assert summary["sum_rate_dt"] == pytest.approx(np.sum(diag["rate_mean"] * dts))


# ------------------------------------------------ the six scripts, tiny, CPU

DRIVER = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)  # tiny tensors; the suite's workers share the cores
    sys.path.insert(0, {scripts!r})
    out = {out!r}
    import torch_death_channel_sweep, torch_diagnose_transdim, torch_quality_families
    import torch_quality_parity, torch_quality_parity_absorbing, torch_quality_scaled_data
    import torch_transdim_operating_points
    tiny = ["--gen-jets", "8", "--gen-chunk", "8", "--device", "cpu"]
    torch_quality_parity.main(["--train-steps", "1", *tiny, "--out", out + "/parity.json",
                               "--jax-readings", {mbm!r}])
    absorbing = ["--epochs", "1", "--sampler-steps", "2", "--stress-jets", "4", "--seeds", "0",
                 "--params-cache", out + "/cache", "--target-dropout", "0.1", *tiny]
    torch_quality_parity_absorbing.main([*absorbing, "--out", out + "/parity_absorbing.json",
                                         "--jax-readings", {absorbing!r}])
    torch_death_channel_sweep.main([*absorbing, "--scales", "0", "1", "--out",
                                    out + "/death.json"])
    for family in ("mbm", "absorbing", "transdim"):
        torch_quality_scaled_data.main([
            "--family", family, "--n-data", "120", "--train-steps", "1", "--batch-size", "64",
            "--hidden", "16", "--blocks", "1", "--sampler-steps", "2", "--boots", "1",
            "--shard", out + "/synth.npz", "--workdir", out + "/scaled", *tiny,
            "--out", out + f"/scaled_{{family}}.json"])
    torch_quality_families.main(["--family", "transdimensional", "--epochs", "0",
                                 "--sampler-steps", "2", "--skip-ref-mode",
                                 "--workdir", out + "/td", *tiny])
    torch_transdim_operating_points.main(["--points", "3x4,2x2", "--reuse-params",
                                          out + "/td/trained_params.pt", *tiny,
                                          "--out", out + "/points.json"])
    torch_diagnose_transdim.main(["--workdir", out + "/td", "--gen-jets", "8",
                                  "--sampler-steps", "4", "--print-every", "2",
                                  "--device", "cpu", "--out", out + "/diagnose.json"])
    assert not any(m == "jax" or m.startswith(("jax.", "multimodal_particles_tpu."))
                   or m == "multimodal_particles_tpu" for m in sys.modules), "JAX imported"
""")


@pytest.fixture(scope="module", autouse=True)
def scripts_run(tmp_path_factory):
    """All six scripts at a tiny size on the CPU, in one subprocess that
    imports nothing of JAX, started before this module's first test so that
    it runs beside the in-process ones; its output goes to files."""
    out = tmp_path_factory.mktemp("sweeps")
    code = DRIVER.format(scripts=os.path.join(ROOT, "scripts"), out=str(out),
                         mbm=os.path.join(ROOT, "benchmarks", "quality_parity_mbm.json"),
                         absorbing=os.path.join(ROOT, "benchmarks",
                                                "quality_parity_absorbing.json"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with open(out / "stdout.txt", "w") as stdout, open(out / "stderr.txt", "w") as stderr:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                stdout=stdout, stderr=stderr)
    yield SimpleNamespace(proc=proc, out=out)
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def outputs(scripts_run):
    """{name: the JSON each script wrote}, once the subprocess has ended."""
    returncode = scripts_run.proc.wait(timeout=600)
    assert returncode == 0, (scripts_run.out / "stderr.txt").read_text()[-4000:]
    return {p.stem: json.loads(p.read_text()) for p in scripts_run.out.glob("*.json")}


def test_quality_parity_writes_every_key(outputs):
    doc = outputs["parity"]
    assert PARITY_KEYS <= doc.keys() and doc["platform"] == "cpu" and doc["device"] == "cpu"
    assert PARITY_SIDE <= doc["rebuilt"].keys()
    assert doc["rebuilt"]["metrics"].keys() == feature_keys(FEATURES)
    assert doc["reference"]["metrics"].keys() == feature_keys(FEATURES)  # the JAX readings
    assert doc["ratio_rebuilt_over_reference"] and doc["jax_readings"]["platform"] == "cpu"
    assert doc["launches"] == {"train": {}, "generate": {}}  # the CPU runs plain versions


def test_quality_parity_absorbing_writes_every_key(outputs):
    doc = outputs["parity_absorbing"]
    assert ABSORBING_KEYS <= doc.keys() and doc["seeds_done"] == [0]
    seed = doc["seeds"][0]
    assert ABSORBING_SEED <= seed.keys()
    assert seed["rebuilt"]["metrics"].keys() == feature_keys(FEATURES)
    assert seed["reference"] is not None  # seed 0 of the JAX readings
    for name in ("halved", "uniform"):
        assert seed["mask_dynamics_stress"][name]["rebuilt"].keys() == STRESS
        assert seed["mask_dynamics_stress"][name]["reference"].keys() >= STRESS


def test_death_channel_sweep_writes_every_key(outputs):
    doc = outputs["death"]
    assert DEATH_KEYS <= doc.keys() and doc["scales"] == [0.0, 1.0]
    seed = doc["seeds"][0]
    assert {"seed", "final_train_loss", "train_wall_s", "scales"} <= seed.keys()
    # the trained model came from the absorbing harness's cache: the same settings
    assert seed["train_wall_s"] == 0.0
    for scale in ("0.0", "1.0"):
        entry = seed["scales"][scale]
        assert {"nominal", "halved", "uniform", "gen_wall_s"} <= entry.keys()
        assert STRESS | {"metrics"} == entry["nominal"].keys()
        assert doc["per_scale_summary"][scale].keys() == DEATH_SUMMARY


@pytest.mark.parametrize("family", ["mbm", "absorbing", "transdim"])
def test_quality_scaled_data_writes_every_key(outputs, family):
    doc = outputs[f"scaled_{family}"]
    assert SCALED_KEYS | SCALED_EXTRA[family] <= doc.keys()
    assert doc["data"].keys() == {"shard", "n_jets", "max_particles", "data_seed"}
    assert {"final_train_loss", "train_wall_s", "gen_wall_s", "metrics"} <= doc["rebuilt"].keys()
    assert doc["rebuilt"]["metrics"].keys() == feature_keys(FEATURES) | {"KL_mult_hist"}
    assert doc["floors_at_this_scale"].keys() >= feature_keys(("pt", "m", "eta", "phi"))
    # the epochs come from the real loader: 96 training jets in batches of 64
    assert doc["train_steps"] == 2


def test_operating_points_and_diagnosis_write_every_key(outputs):
    rows = outputs["points"]["rows"]
    assert [(r["sampler_steps"], r["multi_birth"]) for r in rows] == [(3, 4), (2, 2)]
    assert all(POINT_ROW <= r.keys() for r in rows)
    assert {"protocol", "gate", "rows"} <= outputs["points"].keys()
    diag = outputs["diagnose"]
    assert [r["step"] for r in diag["rows"]] == [0, 2, 3]
    assert all(r.keys() == DIAG_COLUMNS for r in diag["rows"])
    assert 1 <= diag["final"]["mean_dims"] <= 128 and diag["nfe"] == 4
