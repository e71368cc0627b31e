"""The distributional checks of the port's AbsorbingFlow and transdimensional
samplers against the JAX package's (scripts/torch_family_distribution_check.py)
at N = 32, with the EPiC trunk cut to one block and the survival and gsdm
heads to one block of width 32 with one head, so that both checks stay
within 90 s in one process on the CPU (85 s on an 8-core box; the JAX train
steps' first compiles are most of it): each JAX model trained on the bundled
100-jet AspenOpenJets shard (5 steps an epoch; AbsorbingFlow 20 epochs, the
transdimensional model 200), its weights in the port, 1,000 jets sampled from
one source batch by the JAX sampler under four keys and by the port's
sampler (AbsorbingFlow 20 steps, the transdimensional model 16, its headline
multi-birth chain).

Every distance of the port's jets to the first JAX sample (KL and W1 on pt,
η, φ and mass; L1 of the token fractions; the multiplicity histogram's KL;
for the transdimensional model also the dims histogram's KL to the prior's
draws) must lie within 3× the JAX-vs-JAX floor (the mean over three key
pairs) plus the distance's absolute term (`ABS` in the script). Each negative
control (`CONTROLS`: the absorbing pt drift's output bias, its death channel;
the transdimensional birth chain's left-endpoint rate, its prior smoothed)
must exceed the bound on some distance.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import pytest  # noqa: E402
import torch_family_distribution_check as check  # noqa: E402

NUM_JETS = 1000
N = 32
FAMILIES = ("absorbing", "transdimensional")


@pytest.fixture(scope="module")
def results():
    return {}


def result_of(results, family):
    if family not in results:
        cfg = check.make_config(family, N)
        results[family] = check.run_check(family, cfg, NUM_JETS, seed=0)
    return results[family]


@pytest.mark.parametrize("family", FAMILIES)
def test_port_sampler_matches_jax_in_distribution(results, family):
    result = result_of(results, family)
    assert check.MULTIPLE <= 3.0
    assert result["train_loss"][-1] < result["train_loss"][0]
    out = {k: (result["port"][k], result["bound"][k]) for k in result["port"]}
    assert result["port_passes"], out


@pytest.mark.parametrize("family,control", [
    (family, f"{name}={size}") for family in FAMILIES for name, size in check.CONTROLS[family]])
def test_negative_control_lands_above_the_bound(results, family, control):
    result = result_of(results, family)
    neg = result["controls"][control]
    assert result["controls_fail"][control], {k: (neg[k], result["bound"][k]) for k in neg}
