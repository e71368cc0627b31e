"""Jet substructure from scratch: exclusive-kt clustering, N-subjettiness and
energy correlators in numpy, the counterpart of
multimodal_particles_tpu/data/particle_clouds/substructure.py:1-223.

`substructure_observables` computes the batch with the C++ library
(`multimodal_particles_tpu_torch/native/`, about 100× the numpy loop at
1M-jet scale) unless `use_native=False` or no C++ toolchain builds it; its
result's "native" entry says which ran. The tests hold the two to each other
at rtol 1e-6.

Algorithms:
  * kt distance  d_ij = min(pt_i², pt_j²) · ΔR_ij² / R²,  d_iB = pt_i²
  * exclusive clustering: E-scheme merges until `n_jets` pseudojets remain
  * τ_N = Σ_i pt_i · min_k ΔR(axis_k, i)^β / d0,  d0 = Σ_i pt_i R^β
  * ECF_N with angular exponent β=1; D2 = ECF3 · ECF1³ / ECF2³
"""

import numpy as np

from multimodal_particles_tpu_torch.native import substructure_batch_native


def _delta_r2(eta1, phi1, eta2, phi2):
    deta = eta1 - eta2
    dphi = np.abs(phi1 - phi2)
    dphi = np.where(dphi > np.pi, 2.0 * np.pi - dphi, dphi)
    return deta**2 + dphi**2


def _four_mom(pt, eta, phi):
    px = pt * np.cos(phi)
    py = pt * np.sin(phi)
    pz = pt * np.sinh(eta)
    e = pt * np.cosh(eta)  # massless constituents
    return px, py, pz, e


def exclusive_kt_axes(pt, eta, phi, n_jets, R=0.8):
    """Exclusive-kt subjet axes for one jet.

    Args:
      pt, eta, phi: (n,) arrays of valid constituents (n >= n_jets).
    Returns:
      (n_jets, 2) array of (eta, phi) axes, pt-ordered descending.
    """
    px, py, pz, e = _four_mom(pt, eta, phi)
    px, py, pz, e = (list(v.astype(np.float64)) for v in (px, py, pz, e))
    alive = list(range(len(pt)))

    def kin(i):
        pt_i = np.hypot(px[i], py[i])
        eta_i = np.arcsinh(pz[i] / max(pt_i, 1e-30))
        phi_i = np.arctan2(py[i], px[i])
        return pt_i, eta_i, phi_i

    while len(alive) > n_jets:
        kins = np.array([kin(i) for i in alive])  # (m, 3)
        pts, etas, phis = kins[:, 0], kins[:, 1], kins[:, 2]
        dr2 = _delta_r2(etas[:, None], phis[:, None], etas[None, :], phis[None, :])
        kt2 = pts**2
        dij = np.minimum(kt2[:, None], kt2[None, :]) * dr2 / (R * R)
        np.fill_diagonal(dij, np.inf)
        a, b = np.unravel_index(np.argmin(dij), dij.shape)
        i, j = alive[a], alive[b]
        # E-scheme recombination: merge j into i, retire j's slot
        px[i] += px[j]
        py[i] += py[j]
        pz[i] += pz[j]
        e[i] += e[j]
        alive.pop(b)

    axes = np.array([kin(i) for i in alive])  # (n_jets, 3) pt, eta, phi
    order = np.argsort(-axes[:, 0])
    return axes[order][:, 1:3], axes[order][:, 0]


def inclusive_kt_jets(pt, eta, phi, R=0.8):
    """Full kt clustering with beam distances; returns (pt, eta, phi) of
    inclusive jets, pt-ordered."""
    px, py, pz, e = _four_mom(pt, eta, phi)
    px, py, pz, e = (list(v.astype(np.float64)) for v in (px, py, pz, e))
    alive = list(range(len(pt)))
    jets = []

    def kin(i):
        pt_i = np.hypot(px[i], py[i])
        eta_i = np.arcsinh(pz[i] / max(pt_i, 1e-30))
        phi_i = np.arctan2(py[i], px[i])
        return pt_i, eta_i, phi_i

    while alive:
        kins = np.array([kin(i) for i in alive])
        pts, etas, phis = kins[:, 0], kins[:, 1], kins[:, 2]
        kt2 = pts**2
        if len(alive) == 1:
            jets.append(kins[0])
            break
        dr2 = _delta_r2(etas[:, None], phis[:, None], etas[None, :], phis[None, :])
        dij = np.minimum(kt2[:, None], kt2[None, :]) * dr2 / (R * R)
        np.fill_diagonal(dij, np.inf)
        a, b = np.unravel_index(np.argmin(dij), dij.shape)
        diB_min = np.argmin(kt2)
        if kt2[diB_min] < dij[a, b]:
            jets.append(kins[diB_min])
            alive.pop(diB_min)
        else:
            i, j = alive[a], alive[b]
            px[i] += px[j]
            py[i] += py[j]
            pz[i] += pz[j]
            e[i] += e[j]
            alive.pop(b)

    jets = np.array(jets)
    return jets[np.argsort(-jets[:, 0])]


def nsubjettiness(pt, eta, phi, axes, beta=1.0, R=0.8):
    """τ_N for given subjet axes (reference computes this manually from
    fastjet exclusive axes — jets.py:246-303)."""
    d0 = np.sum(pt * R**beta)
    dr = np.sqrt(
        _delta_r2(eta[:, None], phi[:, None], axes[None, :, 0], axes[None, :, 1])
    )  # (n, N)
    return np.sum(pt * np.min(dr, axis=1) ** beta) / d0


def energy_correlators(pt, eta, phi, beta=1.0):
    """Normalized 2- and 3-point energy correlation functions (β exponent)."""
    z = pt / np.sum(pt)
    dr = np.sqrt(
        _delta_r2(eta[:, None], phi[:, None], eta[None, :], phi[None, :])
    ) ** beta
    n = len(pt)
    iu = np.triu_indices(n, k=1)
    e2 = np.sum(z[iu[0]] * z[iu[1]] * dr[iu])
    # e3 via vectorized triple loop: sum over i<j<k z_i z_j z_k θij θik θjk
    zdr = z[:, None] * dr  # zdr[i, k] = z_i θ_ik
    e3 = 0.0
    for j in range(1, n - 1):
        # pairs (i<j, k>j): Σ_i<j Σ_k>j z_i z_j z_k θij θik θjk
        left = z[:j] * dr[:j, j]  # (j,) z_i θ_ij
        right = z[j + 1 :] * dr[j, j + 1 :]  # (n-j-1,) z_k θ_jk
        cross = dr[:j, j + 1 :]  # (j, n-j-1) θ_ik
        e3 += z[j] * left @ cross @ right
    return e2, e3


def d2_correlator(pt, eta, phi, beta=1.0):
    """D2 = ECF3 · ECF1³ / ECF2³ (normalized z cancels ECF1=1)."""
    e2, e3 = energy_correlators(pt, eta, phi, beta)
    return e3 / max(e2**3, 1e-30)


def substructure_observables(pt, eta, phi, mask, R=0.8, beta=1.0, min_constituents=3,
                             use_native=True):
    """Batch substructure: τ1, τ2, τ3, τ21, τ32, d2 per jet
    (substructure.py:153-223): through the C++ library when `use_native` and
    it builds, else the numpy loop.

    Args:
      pt, eta, phi: (B, N) padded arrays; mask: (B, N) bool/int.
    Returns:
      dict of (B',) arrays over jets with >= min_constituents valid particles
      AND pt > 0, plus 'selection', the boolean index into the batch, and
      'native', whether the C++ library computed them.
    """
    B = pt.shape[0]
    valid = (np.asarray(mask) > 0) & (pt > 0)
    counts = valid.sum(1)
    selection = counts >= min_constituents

    native = substructure_batch_native(pt, eta, phi, mask, R=R, beta=beta,
                                       min_constituents=min_constituents) if use_native else None
    if native is not None:
        return _observables(native["tau1"], native["tau2"], native["tau3"], native["d2"],
                            selection, native=True)

    tau1 = np.full(B, np.nan)
    tau2 = np.full(B, np.nan)
    tau3 = np.full(B, np.nan)
    d2 = np.full(B, np.nan)

    for b in np.nonzero(selection)[0]:
        v = valid[b]
        p, h, f = pt[b][v].astype(np.float64), eta[b][v].astype(np.float64), phi[b][v].astype(np.float64)
        axes1, _ = exclusive_kt_axes(p, h, f, 1, R)
        axes2, _ = exclusive_kt_axes(p, h, f, 2, R)
        axes3, _ = exclusive_kt_axes(p, h, f, 3, R)
        tau1[b] = nsubjettiness(p, h, f, axes1, beta, R)
        tau2[b] = nsubjettiness(p, h, f, axes2, beta, R)
        tau3[b] = nsubjettiness(p, h, f, axes3, beta, R)
        d2[b] = d2_correlator(p, h, f, beta)
    return _observables(tau1, tau2, tau3, d2, selection, native=False)


def _observables(tau1, tau2, tau3, d2, selection, native):
    with np.errstate(divide="ignore", invalid="ignore"):
        tau21 = tau2 / tau1
        tau32 = tau3 / tau2
    return {
        "tau1": tau1[selection],
        "tau2": tau2[selection],
        "tau3": tau3[selection],
        "tau21": tau21[selection],
        "tau32": tau32[selection],
        "d2": d2[selection],
        "selection": selection,
        "native": native,
    }
