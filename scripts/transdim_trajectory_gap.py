"""Where the unguided transdimensional trajectory's gap between the port and
the JAX package comes from, on the CPU.

The pair of tests/test_torch_conditioning.py (seed 7, N = 16, B = 6, 8 steps
of the single-birth sampler, the birth uniforms halved) sampled unguided from
the draws JAX makes from its key, five ways:

  jax_jit        JAX's sampler as it runs (its scans compiled by XLA)
  jax_eager      the same sampler under `jax.disable_jit()`, operation by
                 operation: the same code, another float32 evaluation
  port           the port's sampler and network
  port_jax_net   the port's sampler calling JAX's network (eager)
  port_1ulp      the port with every entry of its Euler-Maruyama noise moved
                 by one ulp

and each pair's largest |Δ| per jet as a share of the jet's largest |x|
(at least 1), the measure of tests/test_torch_transdim.py::_compare_samples.
If the port parts from JAX by about what JAX's two evaluations part by, the
gap is the flow's amplification of float32 rounding, not a port difference.

    JAX_PLATFORMS=cpu python scripts/transdim_trajectory_gap.py [--out F.json]
"""

import argparse
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (REPO_ROOT, os.path.join(REPO_ROOT, "tests")):
    if path not in sys.path:
        sys.path.insert(0, path)

from multimodal_particles_tpu.models.generative.transdimensional import (  # noqa: E402
    structure as jax_structure,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional import (  # noqa: E402
    structure,
)
from torch_port_helpers import replay_sampler_draws, transdim_pair  # noqa: E402

N, B, STEPS = 16, 6, 8
DRAW_NAMES = ("init", "em_noise", "u_jump", "birth_noise")


def jax_network_for(jax_model, params):
    """The port's `net_forward` signature over JAX's network, eager: the
    nearest atom drawn as argmax(logits + the port's Gumbel noise)."""
    def forward(state, ts, nearest_atom=None, sample_nearest_atom=False, generator=None,
                gumbel=None, predict="eps", fused=False, packed=None, with_rate=True):
        j_state = jax_structure.StructuredState(
            jnp.asarray(state.continuous.numpy()), jnp.asarray(state.discrete.numpy()),
            jnp.asarray(state.dims.numpy()))
        t = jnp.asarray(ts.numpy())
        out = jax_model.net_forward(params, j_state, t,
                                    nearest_atom=jnp.zeros((state.B,), jnp.int32),
                                    predict=predict)
        if sample_nearest_atom:
            nearest = np.argmax(np.asarray(out[4]) + gumbel.numpy(), axis=1).astype(np.int32)
            out = jax_model.net_forward(params, j_state, t, nearest_atom=jnp.asarray(nearest),
                                        predict=predict)

        def tensor(a):
            return torch.from_numpy(np.array(a))
        return (tensor(out[0]), tensor(out[1]), (tensor(out[2][0]), tensor(out[2][1])),
                tensor(out[3]), tensor(out[4]), tensor(out[5]).long())
    return forward


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the readings here too")
    args = ap.parse_args(argv)

    jax_model, params, model, batch = transdim_pair(seed=7, n=N, b=B, sections={
        "sampler_kwargs": {"dt": 1 / STEPS, "multi_birth": 1, "guidance_weight": 2.0}})
    model.graphical_structure = None
    jax_state = jax_structure.state_from_list_batch(batch)
    port_state = structure.state_from_list_batch([torch.from_numpy(np.array(a)) for a in batch])
    key = jax.random.PRNGKey(31)
    draws = replay_sampler_draws(key, jax_model.config.sampler_kwargs, B, N, N * 11)
    draws["u_jump"] = (np.random.default_rng(1).random(draws["u_jump"].shape)
                       * 0.5).astype(np.float32)
    test_draws = {k: draws[k] for k in DRAW_NAMES}

    def jax_run():
        final, _ = jax_model.sampler.sample(jax_model, params, jax_state, key,
                                            test_draws=test_draws)
        return final

    def port_run(d):
        final, _ = model.sample(port_state, draws=d)
        return final

    runs = {"jax_jit": jax_run()}
    with jax.disable_jit():
        runs["jax_eager"] = jax_run()
    runs["port"] = port_run(draws)
    model.net_forward = jax_network_for(jax_model, params)
    try:
        runs["port_jax_net"] = port_run(draws)
    finally:
        del model.net_forward
    nudged = {**draws, "em_noise": np.nextafter(draws["em_noise"], np.float32(np.inf))}
    runs["port_1ulp"] = port_run(nudged)

    lats = {name: np.asarray(state.get_flat_lats()) for name, state in runs.items()}
    dims = {name: np.asarray(state.dims) for name, state in runs.items()}
    scale = np.maximum(np.abs(lats["jax_jit"]).max(axis=1, keepdims=True), 1.0)

    def gap(a, b):
        return [float(v) for v in (np.abs(lats[a] - lats[b]) / scale).max(axis=1)]

    result = {
        "pair": f"tests/test_torch_conditioning.py's (seed 7, N={N}, B={B}, {STEPS} steps, "
                "single birth), unguided, the draws of JAX's key 31",
        "measure": "per jet, max |Δ flat latents| / max(max |x| of the jet under jax_jit, 1)",
        "dims_equal_everywhere": all(bool((d == dims["jax_jit"]).all()) for d in dims.values()),
        "gaps": {f"{a} vs {b}": gap(a, b) for a, b in (
            ("port", "jax_jit"), ("jax_eager", "jax_jit"), ("port", "jax_eager"),
            ("port_jax_net", "jax_jit"), ("port_jax_net", "port"), ("port_1ulp", "port"))},
    }
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
