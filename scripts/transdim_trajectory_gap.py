"""Where the transdimensional trajectory's gap between the port and the JAX
package comes from, on the CPU.

Two pairs (`--pair`):

  conditioning  tests/test_torch_conditioning.py's (seed 7, N = 16, B = 6, 8
                steps of the single-birth sampler, the draws of JAX's key 31,
                the birth uniforms halved)
  context       tests/test_torch_transdim_context.py's (seed 11, N = 16, B =
                8, both contexts, the network cut to one EPiC block and one
                32-wide gsdm block with one head, 4 steps, key 41)

sampled from the draws JAX makes from its key (`--guided`: under its
reconstruction guidance, the first 3 rows observed), several ways:

  jax_jit           JAX's sampler as it runs (its scans compiled by XLA)
  jax_eager         the same sampler under `jax.disable_jit()`, operation by
                    operation: the same code, another float32 evaluation
  jax_eager_jit_net the same sampler operation by operation, its network
                    compiled on its own (unguided only)
  port              the port's sampler and network
  port_jax_net      the port's sampler calling JAX's network operation by
                    operation (unguided only)
  port_jax_jit_net  the port's sampler calling JAX's network compiled
  port_1ulp         the port with every entry of its Euler-Maruyama noise
                    moved by one ulp

and each pair's largest |Δ| per jet as a share of the jet's largest |x|
(at least 1), the measure of tests/test_torch_transdim.py::_compare_samples.
If the port parts from JAX by about what JAX's two evaluations part by, the
gap is the flow's amplification of float32 rounding, not a port difference.
Then, one network evaluation at a time along the port's trajectory, the
port's network, JAX's compiled and JAX's operation-by-operation network on
the port's inputs (the same state, times and Gumbel noise): each output's
largest |Δ| as a share of max(1, its largest |value|).

    JAX_PLATFORMS=cpu python scripts/transdim_trajectory_gap.py [--pair context] [--guided] [--out F.json]
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
    sampler as jax_sampler,
)
from multimodal_particles_tpu.models.generative.transdimensional import (  # noqa: E402
    structure as jax_structure,
)
from multimodal_particles_tpu_torch.models.generative.transdimensional import (  # noqa: E402
    sampler,
    structure,
)
from torch_port_helpers import replay_sampler_draws, transdim_pair  # noqa: E402

DRAW_NAMES = ("init", "em_noise", "u_jump", "birth_noise")
OBSERVED = 3  # rows a guided jet has observed


def make_pair(name, steps=None):
    """(jax_model, params, model, batch, B, N, key, birth-uniform seed); `steps`
    replaces the pair's step count."""
    if name == "conditioning":
        n, b = 16, 6
        pair = transdim_pair(seed=7, n=n, b=b, sections={
            "sampler_kwargs": {"dt": 1 / (steps or 8), "multi_birth": 1, "guidance_weight": 2.0}})
        return (*pair, b, n, jax.random.PRNGKey(31), 1)
    import test_torch_transdim_context as ctx

    sampler_kwargs = {**ctx.SAMPLER, **({"dt": 1 / steps} if steps else {})}
    pair = transdim_pair(seed=11, n=ctx.N, b=ctx.B, drawn_init=True,
                         sections=ctx._sections(ctx.BOTH, sampler_kwargs=sampler_kwargs))
    return (*pair, ctx.B, ctx.N, jax.random.PRNGKey(41), 2)


def jax_state_of(state):
    """The port's state as JAX's, contexts included."""
    def arr(t):
        return None if t is None else jnp.asarray(t.detach().numpy())
    return jax_structure.StructuredState(
        arr(state.continuous), arr(state.discrete), arr(state.dims),
        context_continuous=arr(state.context_continuous),
        context_discrete=arr(state.context_discrete))


def jax_net(jax_model, params):
    """JAX's net_forward with the nearest atom drawn as argmax(logits + the
    given Gumbel noise): (state, ts, gumbel or None) → its outputs."""
    def net(state, ts, gumbel, predict="eps"):
        out = jax_model.net_forward(params, state, ts,
                                    nearest_atom=jnp.zeros((state.B,), jnp.int32),
                                    predict=predict)
        if gumbel is not None:
            nearest = jnp.argmax(out[4] + gumbel, axis=1).astype(jnp.int32)
            out = jax_model.net_forward(params, state, ts, nearest_atom=nearest,
                                        predict=predict)
        return out
    return net


def jax_network_for(jax_model, params, jit=False):
    """The port's `net_forward` signature over JAX's network, operation by
    operation or compiled."""
    net = jax_net(jax_model, params)
    if jit:
        net = jax.jit(net, static_argnames=("predict",))

    def forward(state, ts, nearest_atom=None, sample_nearest_atom=False, generator=None,
                gumbel=None, predict="eps", fused=False, packed=None, with_rate=True):
        g = jnp.asarray(gumbel.numpy()) if sample_nearest_atom else None
        out = net(jax_state_of(state), jnp.asarray(ts.numpy()), g, predict=predict)

        def tensor(a):
            return torch.from_numpy(np.array(a))
        return (tensor(out[0]), tensor(out[1]), (tensor(out[2][0]), tensor(out[2][1])),
                tensor(out[3]), tensor(out[4]), tensor(out[5]).long())
    return forward


def network_gaps(jax_model, params, calls):
    """Along the port's trajectory, each recorded evaluation (state, ts,
    gumbel, the port's outputs) through JAX's network compiled and operation
    by operation: per output, the three pairs' largest |Δ| over max(1, its
    largest |value| under jit)."""
    net = jax_net(jax_model, params)
    jit_net = jax.jit(net)
    rows = []
    for state, ts, gumbel, out in calls:
        args = (jax_state_of(state), jnp.asarray(ts.detach().numpy()),
                None if gumbel is None else jnp.asarray(gumbel.numpy()))
        compiled = jit_net(*args)
        with jax.disable_jit():
            eager = net(*args)
        row = {"t": float(ts[0]), "dims": state.dims.tolist(),
               "nearest_atom_equal": bool((out[5].numpy() == np.asarray(compiled[5])).all()
                                          and (out[5].numpy() == np.asarray(eager[5])).all())}
        for name, p, j, e in (("D", out[0], compiled[0], eager[0]),
                              ("rate", out[1], compiled[1], eager[1]),
                              ("birth_mean", out[2][0], compiled[2][0], eager[2][0]),
                              ("birth_std", out[2][1], compiled[2][1], eager[2][1])):
            p, j, e = p.detach().numpy(), np.asarray(j), np.asarray(e)
            scale = max(1.0, float(np.abs(j).max()))
            row[name] = {"port_vs_jit": float(np.abs(p - j).max() / scale),
                         "eager_vs_jit": float(np.abs(e - j).max() / scale),
                         "port_vs_eager": float(np.abs(p - e).max() / scale)}
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", choices=("conditioning", "context"), default="conditioning")
    ap.add_argument("--steps", type=int, default=None,
                    help="the sampler's steps in place of the pair's (dt = 1 / steps)")
    ap.add_argument("--guided", action="store_true",
                    help="sample under reconstruction guidance, the first 3 rows observed")
    ap.add_argument("--out", default=None, help="write the readings here too")
    args = ap.parse_args(argv)

    jax_model, params, model, batch, B, N, key, birth_seed = make_pair(args.pair, args.steps)
    model.graphical_structure = None
    jax_state = jax_structure.state_from_list_batch(batch)
    port_state = structure.state_from_list_batch([torch.from_numpy(np.array(a)) for a in batch])
    if args.pair == "context":
        import test_torch_transdim_context as ctx

        jax_state, port_state = ctx._states(batch, jax_model.config)
    draws = replay_sampler_draws(key, jax_model.config.sampler_kwargs, B, N, N * 11)
    draws["u_jump"] = (np.random.default_rng(birth_seed).random(draws["u_jump"].shape)
                       * 0.5).astype(np.float32)
    test_draws = {k: draws[k] for k in DRAW_NAMES}
    jax_cond = cond = None
    if args.guided:
        dims = jnp.full((B,), OBSERVED, jnp.int32)
        observed, _ = jax_structure.adjust_state(jax_state.delete_dims(dims))
        mask = jax_state.get_mask_flat(dims)
        jax_cond = jax_sampler.Condition(lats=observed.get_flat_lats() * mask, mask=mask,
                                         dims=dims)
        cond = sampler.Condition.observe(port_state, torch.full((B,), OBSERVED))
    for cfg in (jax_model.config.sampler_kwargs, model.config.sampler_kwargs):
        cfg.do_conditioning = args.guided

    def jax_run():
        final, _ = jax_model.sampler.sample(jax_model, params, jax_state, key,
                                            condition=jax_cond, test_draws=test_draws)
        return final

    def port_run(d):
        final, _ = model.sample(port_state, draws=d, condition=cond)
        return final

    runs = {"jax_jit": jax_run()}
    with jax.disable_jit():
        runs["jax_eager"] = jax_run()
    if not args.guided:
        compiled = jax.jit(jax_model.net_forward,
                           static_argnames=("sample_nearest_atom", "predict", "fused"))

        def compiled_net(*a, **kw):
            with jax.disable_jit(False):
                return compiled(*a, **kw)
        jax_model.net_forward = compiled_net
        try:
            with jax.disable_jit():
                runs["jax_eager_jit_net"] = jax_run()
        finally:
            del jax_model.net_forward
    calls = []
    net_forward = model.net_forward

    def recorded(state, ts, *a, **kw):
        out = net_forward(state, ts, *a, **kw)
        calls.append((state, ts.clone(), kw.get("gumbel"), out))
        return out
    model.net_forward = recorded
    runs["port"] = port_run(draws)
    del model.net_forward
    if not args.guided:  # the guided score differentiates the port's own modules
        for name, jit in (("port_jax_net", False), ("port_jax_jit_net", True)):
            model.net_forward = jax_network_for(jax_model, params, jit)
            try:
                runs[name] = port_run(draws)
            finally:
                del model.net_forward
    nudged = {**draws, "em_noise": np.nextafter(draws["em_noise"], np.float32(np.inf))}
    runs["port_1ulp"] = port_run(nudged)

    lats = {name: np.asarray(state.get_flat_lats()) for name, state in runs.items()}
    dims = {name: np.asarray(state.dims) for name, state in runs.items()}
    scale = np.maximum(np.abs(lats["jax_jit"]).max(axis=1, keepdims=True), 1.0)

    def gap(a, b):
        return [float(v) for v in (np.abs(lats[a] - lats[b]) / scale).max(axis=1)]

    pairs = [("port", "jax_jit"), ("jax_eager", "jax_jit"), ("port", "jax_eager"),
             ("jax_eager_jit_net", "jax_jit"), ("jax_eager_jit_net", "jax_eager"),
             ("port_jax_net", "jax_eager"), ("port_jax_jit_net", "jax_jit"),
             ("port_jax_net", "port"), ("port_1ulp", "port")]
    result = {
        "pair": args.pair, "guided": args.guided, "B": B, "N": N,
        "steps": len(draws["u_jump"]),
        "measure": "per jet, max |Δ flat latents| / max(max |x| of the jet under jax_jit, 1)",
        "dims_equal_everywhere": all(bool((d == dims["jax_jit"]).all()) for d in dims.values()),
        "dims": dims["jax_jit"].tolist(),
        "gaps": {f"{a} vs {b}": gap(a, b) for a, b in pairs if a in lats and b in lats},
        "network_gaps": network_gaps(jax_model, params, calls),
    }
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return result


if __name__ == "__main__":
    main()
