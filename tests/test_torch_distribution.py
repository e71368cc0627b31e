"""The distributional check of the port's MBM sampler against the JAX
package's (scripts/torch_distribution_check.py), at config-berlin widths
(the encoder of config-mbm-test.yaml: 2 blocks, hidden 16) and N = 32 so
that it stays within a few tens of seconds on the CPU: the JAX model trained
3 epochs on the bundled 100-jet AspenOpenJets shard, its weights in the port,
2,000 jets sampled from one source batch (both packages' data code, one
seed) by the JAX sampler under four keys and by the port's sampler.

Every distance of the port's jets to the first JAX sample (KL and W1 on pt,
η, φ and mass; L1 of the token fractions) must lie within 3× the JAX-vs-JAX
floor (the mean over three key pairs) plus the feature's absolute term
(`ABS` in the script). Each negative control, the port with its pt drift's
output bias shifted by 1, 0.1 or 0.03, must exceed the bound on some
distance. The script runs the same check at N = 128 on a 20,000-jet shard.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import pytest  # noqa: E402
import torch_distribution_check as check  # noqa: E402

NUM_JETS = 2000
N = 32


@pytest.fixture(scope="module")
def result():
    return check.run_check(check.make_config(N), NUM_JETS, seed=0)


def test_port_sampler_matches_jax_in_distribution(result):
    assert check.MULTIPLE <= 3.0
    assert result["train_loss"][-1] < result["train_loss"][0]
    out = {k: (result["port"][k], result["bound"][k]) for k in result["port"]}
    assert result["port_passes"], out


@pytest.mark.parametrize("shift", [str(s) for s in check.CONTROL_SHIFTS])
def test_negative_control_lands_above_the_bound(result, shift):
    control = result["controls"][shift]
    assert result["controls_fail"][shift], {k: (control[k], result["bound"][k]) for k in control}
