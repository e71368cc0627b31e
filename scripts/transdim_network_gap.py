"""The transdimensional network's outputs with a sampled nearest atom: the
port against the JAX package's three float32 evaluations of the same
network, on the CPU.

The pair and inputs of tests/test_torch_transdim.py::
test_sampled_nearest_atom_matches_flax (seed 0, N = 16, B = 6, the noisy
state of `_net_inputs(pair, 2)`, the Gumbel noise of JAX's key 11):

  jax_dispatch  `network.apply` called as the test calls it, outside any
                jit: each operation dispatched on its own
  jax_jit       the same under `jax.jit`, compiled by XLA as a whole
  jax_eager     the same under `jax.disable_jit()`
  port          the port's network with that Gumbel noise injected

For each output, its largest |value| under jax_dispatch and each pair's
largest |Δ|; for the nearest atom whether the picks are equal. If the port
parts from JAX by about what JAX's evaluations part by, the gap is float32
rounding at the output's scale.

    JAX_PLATFORMS=cpu python scripts/transdim_network_gap.py [--out F.json]
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

import test_torch_transdim as td  # noqa: E402
from torch_port_helpers import transdim_pair  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the readings here too")
    args = ap.parse_args(argv)

    pair = transdim_pair(seed=0, n=td.N, b=td.B)
    jax_model, params, model, _ = pair
    noisy, ts, _ = td._net_inputs(pair, 2)
    key = jax.random.PRNGKey(11)
    state, zeros = td._jax_state(noisy), jnp.zeros((td.B,), jnp.int32)

    def apply(p, s, t):
        return jax_model.network.apply({"params": p}, s, t, zeros, True, key)

    runs = {"jax_dispatch": apply(params["network"], state, jnp.asarray(ts)),
            "jax_jit": jax.jit(apply)(params["network"], state, jnp.asarray(ts))}
    with jax.disable_jit():
        runs["jax_eager"] = apply(params["network"], state, jnp.asarray(ts))
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (td.B, td.N))))
    with torch.no_grad():
        runs["port"] = model.network(td._torch_state(noisy), torch.from_numpy(ts),
                                     torch.zeros(td.B, dtype=torch.long), True, None, gumbel)
    outputs = {}
    for i, name in enumerate(td.OUTPUTS):
        arrays = {run: np.asarray(out[i].numpy() if torch.is_tensor(out[i]) else out[i])
                  for run, out in runs.items()}
        if name == "nearest_atom":
            outputs[name] = {"equal_everywhere": all(
                np.array_equal(a, arrays["jax_dispatch"]) for a in arrays.values())}
            continue
        outputs[name] = {"max_abs": float(np.abs(arrays["jax_dispatch"]).max())}
        for a, b in (("port", "jax_dispatch"), ("port", "jax_jit"), ("port", "jax_eager"),
                     ("jax_jit", "jax_dispatch"), ("jax_eager", "jax_dispatch"),
                     ("jax_eager", "jax_jit")):
            outputs[name][f"{a} vs {b}"] = float(np.abs(arrays[a] - arrays[b]).max())
    result = {"pair": "tests/test_torch_transdim.py's (seed 0, N=16, B=6), _net_inputs(pair, 2), "
                      "the Gumbel noise of JAX's key 11",
              "measure": "per output, max |Δ| over the tensor", "outputs": outputs}
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
