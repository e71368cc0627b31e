"""JetDataclass (the source–target coupling) and JetClassHighLevelFeatures
(jet observables and the 1D KL/W1 metrics), the counterparts of
multimodal_particles_tpu/data/particle_clouds/jets.py:18-229.

Host-side numpy and scipy, as in the JAX package; scipy.stats (seconds to
import) is imported by the metrics that use it, matplotlib by each plot
(:169-229).
"""

import numpy as np

from multimodal_particles_tpu_torch.data.particle_clouds.particles import ParticleClouds
from multimodal_particles_tpu_torch.data.particle_clouds.substructure import (
    substructure_observables,
)


class JetDataclass:
    """The target jets and the source clouds of a config's data section
    (jets.py:18-81). The source's masks follow the target's multiplicities
    when `source_masks_from_target_masks` is on. `seed` seeds the noise (the
    source's, and the target's padding under `fill_target_with_noise`); the
    JAX class reads it from a `seed` attribute of the data section, which the
    config classes do not have, so there it is unseeded unless a caller sets
    that attribute. Both packages give the same arrays from the same seed."""

    def __init__(self, config, seed=None):
        self.config = config
        self.vocab_size_features = config.data.vocab_size_features
        self.vocab_size_context = config.data.vocab_size_context
        kwargs = dict(config.data.__dict__)
        if seed is not None:
            kwargs["seed"] = seed

        self.target = ParticleClouds(
            dataset=config.data.target_name,
            data_paths=getattr(config.data, "target_path", None),
            **kwargs,
        )

        kwargs["target_multiplicity"] = (
            self.target.multiplicity if config.data.source_masks_from_target_masks else None
        )

        self.source = ParticleClouds(
            dataset=config.data.source_name,
            data_paths=getattr(config.data, "source_path", None),
            **kwargs,
        )

    def preprocess(self, source_stats=None, target_stats=None):
        self.source.preprocess(
            output_continuous=self.config.data.source_preprocess_continuous,
            output_discrete=self.config.data.source_preprocess_discrete,
            stats=source_stats,
        )
        self.config.data.source_preprocess_stats = (
            self.source.stats if hasattr(self.source, "stats") else target_stats
        )
        self.target.preprocess(
            output_continuous=self.config.data.target_preprocess_continuous,
            output_discrete=self.config.data.target_preprocess_discrete,
            stats=target_stats,
        )
        self.config.data.target_preprocess_stats = (
            self.target.stats if hasattr(self.target, "stats") else source_stats
        )

    def postprocess(self, source_stats=None, target_stats=None):
        self.source.postprocess(
            input_continuous=self.config.data.source_preprocess_continuous,
            input_discrete=self.config.data.source_preprocess_discrete,
            stats=self.config.data.source_preprocess_stats if source_stats is None else source_stats,
        )
        self.target.postprocess(
            input_continuous=self.config.data.target_preprocess_continuous,
            input_discrete=self.config.data.target_preprocess_discrete,
            stats=self.config.data.target_preprocess_stats if target_stats is None else target_stats,
        )


class JetClassHighLevelFeatures:
    """Jet kinematics, jet charge, substructure and the 1D fidelity metrics
    of a ParticleClouds in physics space (jets.py:83-168)."""

    def __init__(self, constituents: ParticleClouds, compute_substructure=True):
        self.constituents = constituents

        self.constituents.compute_4mom()
        mask = self.constituents.mask[..., 0] > 0
        self.px = (self.constituents.px * mask).sum(axis=-1)
        self.py = (self.constituents.py * mask).sum(axis=-1)
        self.pz = (self.constituents.pz * mask).sum(axis=-1)
        self.e = (self.constituents.e * mask).sum(axis=-1)
        self.pt = np.sqrt(np.maximum(self.px**2 + self.py**2, 0.0))
        self.m = np.sqrt(np.maximum(self.e**2 - self.px**2 - self.py**2 - self.pz**2, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            self.eta = 0.5 * np.log((self.pt + self.pz) / (self.pt - self.pz))
        self.phi = np.arctan2(self.py, self.px)

        self.multiplicity = np.sum(self.constituents.mask, axis=1)[..., 0]
        if hasattr(self.constituents, "discrete"):
            self.Q_total = self.jet_charge(kappa=0.0)
            self.Q_jet = self.jet_charge(kappa=1.0)

        self.R = 0.8
        self.beta = 1.0
        if compute_substructure:
            self.substructure()

    def jet_charge(self, kappa):
        """Q_j^κ = Σ_i Q_i (pT_i / pT_jet)^κ (jets.py:117-122)."""
        mask = self.constituents.mask[..., 0] > 0
        with np.errstate(divide="ignore", invalid="ignore"):
            q = self.constituents.charge * np.where(mask, self.constituents.pt, 0.0) ** kappa
        return q.sum(axis=1) / np.maximum(self.pt**kappa, 1e-30)

    def substructure(self):
        obs = substructure_observables(
            self.constituents.pt,
            self.constituents.eta_rel,
            self.constituents.phi_rel,
            self.constituents.mask[..., 0],
            R=self.R,
            beta=self.beta,
        )
        self.tau1 = obs["tau1"]
        self.tau2 = obs["tau2"]
        self.tau3 = obs["tau3"]
        self.tau21 = obs["tau21"]
        self.tau32 = obs["tau32"]
        self.d2 = obs["d2"]
        self.substructure_selection = obs["selection"]
        self.substructure_native = obs["native"]  # whether the C++ library computed them

    def histogram(self, features="pt", density=True, num_bins=100, use_quantiles=False):
        x = np.asarray(getattr(self, features)).reshape(-1)
        x = x[np.isfinite(x)]
        bins = (
            np.quantile(x, np.linspace(0.001, 0.999, num_bins)) if use_quantiles else num_bins
        )
        with np.errstate(divide="ignore", invalid="ignore"):
            h = np.histogram(x, density=density, bins=bins)[0]
        # quantile bins of a discrete-valued feature collapse to zero width
        # and give infinite densities: those bins count 0 (jets.py:150-156)
        return np.nan_to_num(h, posinf=0.0, neginf=0.0)

    def KLmetric1D(self, feature, reference, num_bins=100, use_quantiles=True):
        import scipy.stats

        h1 = self.histogram(feature, True, num_bins, use_quantiles) + 1e-8
        h2 = reference.histogram(feature, True, num_bins, use_quantiles) + 1e-8
        return scipy.stats.entropy(h1, h2)

    def Wassertein1D(self, feature, reference):
        import scipy.stats

        x = np.asarray(getattr(self, feature)).reshape(-1)
        y = np.asarray(getattr(reference, feature)).reshape(-1)
        x, y = x[np.isfinite(x)], y[np.isfinite(y)]
        return scipy.stats.wasserstein_distance(x, y)

    def histplot_multiplicities(self, state=None, xlim=None, ylim=None, xlabel=None,
                                ylabel=None, figsize=(3, 3), fontsize=12, ax=None,
                                **kwargs):
        """Histogram of per-jet multiplicities, optionally restricted to a
        set of token states (reference: jets.py:143-175)."""
        import matplotlib.pyplot as plt

        if state is not None:
            if isinstance(state, int):
                state = [state]
            tokens = np.argmax(self.constituents.discrete, axis=-1)[..., None]
            multiplicity = np.zeros(self.constituents.discrete.shape[0])
            for s in state:
                x = (tokens == s) * self.constituents.mask
                multiplicity += x.sum(axis=(1, 2))
        else:
            multiplicity = np.asarray(self.multiplicity)

        if ax is None:
            _, ax = plt.subplots(figsize=figsize)
        vals = multiplicity.reshape(-1)
        bins = np.arange(vals.min() - 0.5, vals.max() + 1.5)
        ax.hist(vals, bins=bins, histtype="step", **kwargs)
        ax.set_xlabel(xlabel, fontsize=fontsize)
        ax.set_ylabel(ylabel, fontsize=fontsize)
        ax.set_xlim(xlim)
        ax.set_ylim(ylim)
        return ax

    def flavor_fractions(self, figsize=(3, 3), fontsize=12, ax=None, **kwargs):
        """Token-state occupancy over valid particles
        (reference: jets.py:177-202)."""
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=figsize)
        tokens = np.argmax(self.constituents.discrete, axis=-1)
        valid = self.constituents.mask[..., 0] > 0
        ax.hist(tokens[valid].reshape(-1), bins=np.arange(-0.5, 8.5),
                histtype="step", **kwargs)
        ax.set_xlabel("Particle flavor", fontsize=fontsize)
        ax.set_xticks(np.arange(8))
        ax.set_xticklabels(
            [r"$\gamma$", r"$h^0$", r"$h^-$", r"$h^+$",
             r"$e^-$", r"$e^+$", r"$\mu^-$", r"$\mu^+$"]
        )
        return ax

    def histplot(self, features="pt", xlim=None, ylim=None, xlabel=None, ylabel=None,
                 figsize=(3, 3), fontsize=12, ax=None, **kwargs):
        import matplotlib.pyplot as plt

        x = np.asarray(getattr(self, features)).reshape(-1)
        if ax is None:
            _, ax = plt.subplots(figsize=figsize)
        ax.hist(x[np.isfinite(x)], histtype="step", **kwargs)
        ax.set_xlabel(features if xlabel is None else xlabel, fontsize=fontsize)
        ax.set_ylabel(ylabel, fontsize=fontsize)
        ax.set_xlim(xlim)
        ax.set_ylim(ylim)
        return ax
