"""ParticleClouds: the host-side container of padded particle clouds
(continuous kinematics, discrete flavour and charge, existence mask), the
counterpart of multimodal_particles_tpu/data/particle_clouds/particles.py:30-228.

Plain numpy, as in the JAX package. The bridge-state branch takes the port's
states (`HybridState`, `AbsorbingBridgeState`) of tensors on any device. The
plots (`histplot`, `display_cloud`, :193-228) import matplotlib when called.
"""

import os

import numpy as np
import torch

from multimodal_particles_tpu_torch import test_resources_dir
from multimodal_particles_tpu_torch.data.particle_clouds.utils import (
    extract_aoj_features,
    extract_jetclass_features,
    physics_to_onehot,
    sample_masks,
    sample_noise,
    tokens_to_physics,
)

AOJ_DEFAULT_PATH = os.path.join(test_resources_dir, "data", "2016H_job0_mini.npz")


def _to_numpy(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ParticleClouds:
    """Constructor branches for arrays, bridge states, JetClass, AspenOpenJets
    and noise sources (particles.py:30-91). `data_params` are the data
    config's fields; its `seed` (absent from the config classes, so None
    unless the caller sets it) seeds the noise."""

    def __init__(self, dataset="JetClass", data_paths=None, **data_params):
        rng = np.random.default_rng(data_params.get("seed", None))

        if isinstance(dataset, np.ndarray) or (
            hasattr(dataset, "ndim") and hasattr(dataset, "shape")
        ):
            data = _to_numpy(dataset)
            self.continuous = data[..., :3].astype(np.float32)
            self.discrete = data[..., 3:-1].astype(np.int64)
            self.mask = data[..., -1:].astype(np.int64)
            if self.discrete.size == 0:
                del self.discrete

        elif hasattr(dataset, "continuous") and (
            hasattr(dataset, "absorbing") or hasattr(dataset, "mask_t")
        ):
            # HybridState or AbsorbingBridgeState
            self.continuous = _to_numpy(dataset.continuous).astype(np.float32)
            self.discrete = _to_numpy(dataset.discrete)
            mask = getattr(dataset, "absorbing", None)
            if mask is None:
                mask = dataset.mask_t
            self.mask = _to_numpy(mask).astype(np.int64)
            if self.discrete is None or self.discrete.size == 0:
                del self.discrete
            else:
                self.discrete = self.discrete.astype(np.int64)

        elif "JetClass" in str(dataset):
            assert data_paths is not None, "Specify the path to the JetClass dataset"
            self.continuous, self.discrete, self.mask = extract_jetclass_features(
                data_paths, **data_params
            )
            if data_params.get("fill_target_with_noise", False):
                self._fill_padding_with_noise(rng)

        elif "AspenOpenJets" in str(dataset):
            if data_paths is None:
                data_paths = [AOJ_DEFAULT_PATH]
            self.continuous, self.discrete, self.mask = extract_aoj_features(
                data_paths, **data_params
            )
            if data_params.get("fill_target_with_noise", False):
                self._fill_padding_with_noise(rng)

        elif "Noise" in str(dataset):
            self.continuous, self.discrete = sample_noise(rng, dataset, **data_params)
            self.mask = sample_masks(rng, **data_params)
            self.continuous = self.continuous * self.mask
            self.discrete = self.discrete * self.mask

        else:
            raise ValueError(f"unknown dataset spec {dataset!r}")

        self._refresh_views()

    def _fill_padding_with_noise(self, rng):
        """Padded slots get Gaussian continuous features and uniform-token
        discrete features, so that the hybrid bridge has a state on every
        slot (particles.py:93-106)."""
        pad = ~(self.mask > 0)
        noise_continuous = rng.standard_normal(self.continuous.shape).astype(np.float32)
        noise_tokens = rng.integers(0, 8, size=self.mask.shape)
        flavor, charge = tokens_to_physics(noise_tokens)
        noise_discrete = np.concatenate([flavor, charge], axis=-1)
        self.continuous = self.continuous + noise_continuous * pad
        self.discrete = self.discrete + noise_discrete * pad

    def _refresh_views(self):
        self.pt = self.continuous[..., 0]
        self.eta_rel = self.continuous[..., 1]
        self.phi_rel = self.continuous[..., 2]
        self.multiplicity = np.sum(self.mask, axis=1)
        if hasattr(self, "discrete") and self.discrete.shape[-1] > 1:
            self.flavor = self.discrete[..., :-1]
            self.charge = self.discrete[..., -1]

    def __len__(self):
        return self.continuous.shape[0]

    def compute_4mom(self):
        self.px = self.pt * np.cos(self.phi_rel)
        self.py = self.pt * np.sin(self.phi_rel)
        self.pz = self.pt * np.sinh(self.eta_rel)
        self.e = self.pt * np.cosh(self.eta_rel)

    def summary_stats(self):
        mask = self.mask[..., 0] > 0
        data = self.continuous[mask]
        return {
            "mean": data.mean(0).tolist(),
            "std": data.std(0, ddof=1).tolist(),
            "min": data.min(0).tolist(),
            "max": data.max(0).tolist(),
        }

    def preprocess(self, output_continuous="standardize", output_discrete="tokens", stats=None):
        """Standardise the kinematics and tokenise flavour and charge
        (particles.py:138-159)."""
        if output_discrete == "onehot_dequantize":
            one_hot = physics_to_onehot(
                self.discrete[..., :-1], self.discrete[..., -1]
            ).astype(np.float32)
            self.continuous = np.concatenate([self.continuous, one_hot], axis=-1)
            del self.discrete
        elif output_discrete == "tokens":
            one_hot = physics_to_onehot(self.discrete[..., :-1], self.discrete[..., -1])
            self.discrete = np.argmax(one_hot, axis=-1)[..., None].astype(np.int64)

        if output_continuous == "standardize":
            self.stats = self.summary_stats() if stats is None else stats
            mean = np.asarray(self.stats["mean"], dtype=np.float32)
            std = np.asarray(self.stats["std"], dtype=np.float32)
            self.continuous = (self.continuous - mean) / std
            self.continuous = self.continuous * self.mask
        self._refresh_views()

    def postprocess(self, input_continuous="standardize", input_discrete="tokens", stats=None):
        """Back to physics space (particles.py:161-191). An explicit `stats`
        wins over the container's own."""
        if input_continuous == "standardize":
            if input_discrete == "onehot_dequantize":
                self.continuous = np.concatenate([self.continuous, self.discrete], axis=-1)
            stats = stats if stats is not None else getattr(self, "stats", None)
            mean = np.asarray(stats["mean"], dtype=np.float32)
            std = np.asarray(stats["std"], dtype=np.float32)
            self.continuous = self.continuous * std + mean
            self.continuous = self.continuous * self.mask

        if input_discrete == "onehot_dequantize":
            tokens = np.argmax(self.continuous[..., 3:], axis=-1)[..., None]
            flavor, charge = tokens_to_physics(tokens)
            self.discrete = np.concatenate([flavor, charge], axis=-1) * self.mask
            self.continuous = self.continuous[..., :3]

        if input_discrete == "tokens":
            flavor, charge = tokens_to_physics(self.discrete)
            self.discrete = np.concatenate([flavor, charge], axis=-1) * self.mask

        self._refresh_views()

    # plots (particles.py:193-228); matplotlib is imported by each

    def histplot(self, feature="pt", idx=None, xlim=None, ylim=None, xlabel=None,
                 ylabel=None, figsize=(3, 3), fontsize=12, ax=None, **kwargs):
        import matplotlib.pyplot as plt

        mask = self.mask[..., 0] > 0
        if ax is None:
            _, ax = plt.subplots(figsize=figsize)
        x = getattr(self, feature)[mask] if idx is None else getattr(self, feature)[:, idx]
        ax.hist(np.asarray(x).reshape(-1), histtype="step", **kwargs)
        ax.set_xlabel(feature if xlabel is None else xlabel, fontsize=fontsize)
        ax.set_ylabel(ylabel, fontsize=fontsize)
        ax.set_xlim(xlim)
        ax.set_ylim(ylim)
        return ax

    def display_cloud(self, idx, scale_marker=1.0, ax=None, figsize=(3, 3), **kwargs):
        import matplotlib.pyplot as plt

        valid = self.mask[idx, :, 0] > 0
        eta = self.eta_rel[idx][valid]
        phi = self.phi_rel[idx][valid]
        pt = self.pt[idx][valid] * scale_marker
        flavor = np.argmax(self.flavor[idx][valid], axis=-1)
        charge = self.charge[idx][valid]
        if ax is None:
            _, ax = plt.subplots(figsize=figsize)
        colors = {0: "gold", 1: "darkred", 2: "darkred", 3: "blue", 4: "green"}
        for fl in range(5):
            for q, marker in ((-1, "^"), (0, "o"), (1, "v")):
                sel = (flavor == fl) & (charge == q)
                if sel.any():
                    ax.scatter(eta[sel], phi[sel], s=pt[sel], marker=marker,
                               color=colors[fl], alpha=0.5)
        ax.set_xticks([])
        ax.set_yticks([])
        return ax
