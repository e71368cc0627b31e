"""Structured transdimensional state for particle clouds
(multimodal_particles_tpu/models/generative/transdimensional/structure.py:31-344).

One fixed-shape state

    StructuredState(continuous (B,N,Dc), discrete (B,N,V), dims (B,))

carries a batch whose jets differ in their number of live particles, and every
dimension operation is mask arithmetic over static shapes: a deletion
multiplies by `arange(N) < dims`, the "next deleted / added dimension" masks
are one-hot rows at dims−1 / dims. No tensor changes its shape.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StructuredState:
    """Fixed-shape transdimensional state. `dims[b]` ∈ [0, N] is the live
    particle count of jet b; rows ≥ dims are zero padding."""

    continuous: torch.Tensor  # (B, N, Dc)
    discrete: torch.Tensor  # (B, N, V) noisy one-hot channels
    dims: torch.Tensor  # (B,) int32
    context_continuous: Optional[torch.Tensor] = None  # observed, not in the latents
    context_discrete: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "StructuredState":
        return dataclasses.replace(self, **changes)

    @property
    def B(self):
        return self.continuous.shape[0]

    @property
    def N(self):
        return self.continuous.shape[1]

    @property
    def Dc(self):
        return self.continuous.shape[2]

    @property
    def V(self):
        return self.discrete.shape[2]

    @property
    def flat_dim(self):
        return self.N * (self.Dc + self.V)

    # ------------------------------------------------------------- flat view

    def _flat(self, cont, disc):
        """[continuous | discrete], each flattened over (N, features)."""
        return torch.cat([cont.reshape(self.B, -1), disc.reshape(self.B, -1)], dim=1)

    def _rows_to_flat(self, rows):
        """(B, N) per-row values → flat (B, N·(Dc+V)), a row's value on each
        of its features."""
        r = rows[:, :, None]
        return self._flat(r.expand(self.B, self.N, self.Dc), r.expand(self.B, self.N, self.V))

    def get_flat_lats(self):
        return self._flat(self.continuous, self.discrete)

    def set_flat_lats(self, flat):
        B, N, Dc, V = self.B, self.N, self.Dc, self.V
        return self.replace(continuous=flat[:, : N * Dc].reshape(B, N, Dc),
                            discrete=flat[:, N * Dc:].reshape(B, N, V))

    # ----------------------------------------------------------------- masks

    def particle_mask(self, dims=None):
        """(B, N) float mask of live rows."""
        dims = self.dims if dims is None else dims
        slots = torch.arange(self.N, device=self.continuous.device)
        return (slots[None, :] < dims[:, None]).to(self.continuous.dtype)

    def get_mask_flat(self, dims=None):
        """Flat (B, N·(Dc+V)) existence mask."""
        return self._rows_to_flat(self.particle_mask(dims))

    def get_next_dim_deleted_mask(self):
        """1 on the row removed by moving down one dimension class (row dims−1)."""
        return self.get_mask_flat(self.dims) - self.get_mask_flat(self.dims - 1)

    def get_next_dim_added_mask(self):
        """1 on the row added by moving up one dimension class (row dims);
        zero when dims == N."""
        return (self.get_mask_flat(torch.clamp(self.dims + 1, max=self.N))
                - self.get_mask_flat(self.dims))

    # -------------------------------------------------------- dim operations

    def delete_dims(self, new_dims):
        """Zero the rows ≥ new_dims."""
        pm = self.particle_mask(new_dims)[:, :, None]
        return self.replace(continuous=self.continuous * pm, discrete=self.discrete * pm,
                            dims=new_dims.to(torch.int32))

    def delete_one_dim(self):
        return self.delete_dims(self.dims - 1)

    def add_dim_where_not_max(self):
        return self.replace(dims=(self.dims + (self.dims < self.N)).to(torch.int32))

    def convert_problem_dim_to_tensor_dim(self, problem_dim_data):
        """(B, N) per-dimension-class values → flat (B, N·(Dc+V)) with row r's
        features all equal to problem_dim_data[:, r]."""
        return self._rows_to_flat(problem_dim_data)

    # ----------------------------------------------------------- conversions

    def to_multimodal_bridge_databatch(self):
        """→ (one_hot, tokens, continuous, ctx_cont, ctx_disc, mask)."""
        tokens = torch.argmax(self.discrete, dim=-1)[..., None]
        mask = self.particle_mask()[:, :, None].to(torch.int32)
        return (self.discrete, tokens, self.continuous, self.context_continuous,
                self.context_discrete, mask)


# ------------------- centre of mass, creation targets, the nearest particle


def adjust_state(state: StructuredState):
    """NaN scrub and centre-of-mass subtraction of the continuous features
    over the live rows (structure.py:158-173); a jet with dims == 0 counts
    every row as live. Returns (new_state, mean (B,1,Dc))."""
    cont = torch.nan_to_num(state.continuous)
    disc = torch.nan_to_num(state.discrete)
    node_mask = state.particle_mask()[:, :, None]  # (B, N, 1)
    node_mask = torch.where((state.dims == 0)[:, None, None], torch.ones_like(node_mask), node_mask)
    n = node_mask.sum(dim=1, keepdim=True)
    mean = cont.sum(dim=1, keepdim=True) / torch.clamp(n, min=1.0)
    return state.replace(continuous=cont - mean * node_mask, discrete=disc), mean


def get_auto_target(state: StructuredState, adjust_val):
    """The ground-truth creation vector: the full state shifted by the
    deleted batch's centre of mass, flattened (structure.py:176-184)."""
    node_mask = state.particle_mask()[:, :, None]
    B = state.B
    return torch.cat([((state.continuous - adjust_val) * node_mask).reshape(B, -1),
                      state.discrete.reshape(B, -1)], dim=1)


def get_nearest_atom(state: StructuredState, delxt_state: StructuredState):
    """Index of the surviving particle closest to the deleted one
    (structure.py:187-200)."""
    batch_idx = torch.arange(state.B, device=state.continuous.device)
    missing_pos = state.continuous[batch_idx, torch.clamp(state.dims - 1, min=0).long(), :]
    d2 = ((delxt_state.continuous - missing_pos[:, None, :]) ** 2).sum(dim=2)  # (B, N)
    atom_mask = delxt_state.particle_mask()
    d2 = atom_mask * d2 + (1.0 - atom_mask) * 1e3
    return torch.argmin(d2, dim=1)


# ------------------------------------------------------- multiplicity prior


class DistributionNodes:
    """Categorical prior over particle multiplicities from an empirical
    histogram {multiplicity: count} (structure.py:208-232)."""

    def __init__(self, histogram: dict):
        self.n_nodes = np.array(sorted(histogram.keys()), dtype=np.int32)
        probs = np.array([histogram[int(n)] for n in self.n_nodes], dtype=np.float64)
        self.probs = probs / probs.sum()
        self.log_probs = np.log(self.probs + 1e-30)

    def sample(self, generator, n_samples=1, device=None):
        probs = torch.from_numpy(self.probs).to(device=device, dtype=torch.float32)
        idx = torch.multinomial(probs, n_samples, replacement=True, generator=generator)
        return torch.from_numpy(self.n_nodes).to(device)[idx]

    def log_prob(self, batch_n_nodes):
        """Log-probability of each multiplicity (an exact match of a
        histogram key is expected; others take a neighbouring slot's)."""
        batch_n_nodes = torch.as_tensor(batch_n_nodes)
        nodes = torch.from_numpy(self.n_nodes).to(batch_n_nodes.device)
        idx = torch.clamp(torch.searchsorted(nodes, batch_n_nodes.to(nodes.dtype)), 0,
                          len(self.n_nodes) - 1)
        return torch.from_numpy(self.log_probs).to(batch_n_nodes.device, torch.float32)[idx]


class JetsGraphicalStructure:
    """Shape and metadata holder of the jets problem with the multiplicity
    prior (structure.py:235-280); the heavy operations are the module-level
    functions above."""

    def __init__(self, datamodule):
        config = datamodule.config
        self.names_in_batch = datamodule.names_in_batch
        self.max_num_particles = config.data.max_num_particles
        self.max_problem_dim = config.data.max_num_particles
        self.num_jets = config.data.num_jets
        self.name_to_index = datamodule.name_to_index

        self.dim_features_continuous = config.data.dim_features_continuous
        self.dim_features_discrete = config.data.dim_features_discrete
        self.dim_context_continuous = config.data.dim_context_continuous
        self.dim_context_discrete = config.data.dim_context_discrete
        self.vocab_size_features = config.data.vocab_size_features
        self.vocab_size_context = config.data.vocab_size_context

        self.with_onehot_shapes = datamodule.with_onehot_shapes
        self.without_onehot_shapes = datamodule.without_onehot_shapes

        self.nodes_dist = DistributionNodes(datamodule.histogram_target)

    def shapes_with_onehot(self):
        return self.with_onehot_shapes

    def shapes_without_onehot(self):
        return self.without_onehot_shapes

    adjust_st_batch = staticmethod(adjust_state)
    get_auto_target = staticmethod(get_auto_target)
    get_nearest_atom = staticmethod(get_nearest_atom)


class Structure:
    """Which tensors of a batch exist, are observed or are latent
    (structure.py:283-306)."""

    def __init__(self, exist, observed, dataset):
        self.exist = np.array(exist, dtype=np.uint8)
        self.observed = np.array([o for o, e in zip(observed, self.exist) if e], dtype=np.uint8)
        self.latent = 1 - self.observed
        is_onehot = getattr(dataset, "is_onehot", [0] * len(self.exist))
        self.is_onehot = [oh for oh, e in zip(is_onehot, self.exist) if e]
        names = getattr(dataset, "names_in_batch",
                        [f"tensor_{i}" for i in range(len(self.exist))])
        self.names = [n for n, e in zip(names, self.exist) if e]
        if hasattr(dataset, "graphical_structure"):
            self.graphical_structure = dataset.graphical_structure

    @property
    def latent_names(self):
        return [n for n, latent in zip(self.names, self.latent) if latent]


class StructuredArgument:
    """Per-tensor scalars broadcast to the flat latent layout
    (structure.py:309-326)."""

    def __init__(self, arg, state_template: StructuredState, observed=None):
        if isinstance(arg, (int, float)):
            arg = (arg, arg)
        if len(arg) == 1:
            arg = tuple(arg) * 2
        self.tensorwise_arg = tuple(arg)
        self.template = state_template

    @property
    def lats(self):
        t = self.template
        device = t.continuous.device
        cont = torch.full((1, t.N * t.Dc), float(self.tensorwise_arg[0]), device=device)
        disc = torch.full((1, t.N * t.V), float(self.tensorwise_arg[1]), device=device)
        return torch.cat([cont, disc], dim=1)


def state_from_list_batch(batch) -> StructuredState:
    """A StructuredState from the 'list' databatch [n_particles,
    target_continuous, target_discrete_onehot, (contexts...)]
    (structure.py:329-344)."""
    continuous = torch.as_tensor(batch[1], dtype=torch.float32)
    device = continuous.device
    return StructuredState(
        continuous=continuous,
        discrete=torch.as_tensor(batch[2], dtype=torch.float32, device=device),
        dims=torch.as_tensor(batch[0], device=device).to(torch.int32),
        context_continuous=torch.as_tensor(batch[3], device=device) if len(batch) > 3 else None,
        context_discrete=torch.as_tensor(batch[4], device=device) if len(batch) > 4 else None,
    )
