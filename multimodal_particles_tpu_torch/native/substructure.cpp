// Jet substructure over padded particle-cloud batches: exclusive-kt
// clustering, N-subjettiness and energy correlators, the port's copy of
// multimodal_particles_tpu/native/substructure.cpp: the same arithmetic a
// jet and the same C interface; a large batch is split over threads.
//
// Observables: tau1/2/3 from E-scheme exclusive-kt axes (O(N^2) a merge)
// and D2 from the 2- and 3-point energy correlators. Called through ctypes
// from multimodal_particles_tpu_torch/native/__init__.py, which builds this
// file at first use with g++ -O3 -shared -fPIC -std=c++17 -pthread; the numpy
// version (data/particle_clouds/substructure.py) computes the same.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr int kJetsPerThread = 256;

struct PseudoJet {
  double px, py, pz, e;
  bool alive;
};

inline double jet_pt(const PseudoJet& j) { return std::hypot(j.px, j.py); }

inline double jet_eta(const PseudoJet& j) {
  double pt = jet_pt(j);
  return std::asinh(j.pz / (pt > 1e-30 ? pt : 1e-30));
}

inline double jet_phi(const PseudoJet& j) { return std::atan2(j.py, j.px); }

inline double delta_r2(double eta1, double phi1, double eta2, double phi2) {
  double deta = eta1 - eta2;
  double dphi = std::fabs(phi1 - phi2);
  if (dphi > kPi) dphi = 2.0 * kPi - dphi;
  return deta * deta + dphi * dphi;
}

// Exclusive-kt clustering down to n_jets axes (E-scheme recombination).
// Fills axes_eta/axes_phi (pt-descending). Returns number of axes produced:
// more than n_jets when no pair has a finite distance below 1e300 (non-finite
// kinematics stop the clustering early); only the first n_jets are written,
// the arrays hold no more.
int exclusive_kt_axes(const double* pt, const double* eta, const double* phi,
                      int n, int n_jets, double R, double* axes_eta,
                      double* axes_phi) {
  if (n < n_jets) return 0;
  std::vector<PseudoJet> jets(n);
  std::vector<double> ceta(n), cphi(n), cpt2(n);
  int alive_count = n;
  for (int i = 0; i < n; ++i) {
    double cphi_i = std::cos(phi[i]), sphi_i = std::sin(phi[i]);
    jets[i] = {pt[i] * cphi_i, pt[i] * sphi_i, pt[i] * std::sinh(eta[i]),
               pt[i] * std::cosh(eta[i]), true};
    ceta[i] = eta[i];
    cphi[i] = phi[i];
    cpt2[i] = pt[i] * pt[i];
  }

  double R2 = R * R;
  while (alive_count > n_jets) {
    double best = 1e300;
    int bi = -1, bj = -1;
    for (int i = 0; i < n; ++i) {
      if (!jets[i].alive) continue;
      for (int j = i + 1; j < n; ++j) {
        if (!jets[j].alive) continue;
        double kt2 = cpt2[i] < cpt2[j] ? cpt2[i] : cpt2[j];
        double d = kt2 * delta_r2(ceta[i], cphi[i], ceta[j], cphi[j]) / R2;
        if (d < best) {
          best = d;
          bi = i;
          bj = j;
        }
      }
    }
    if (bi < 0) break;
    jets[bi].px += jets[bj].px;
    jets[bi].py += jets[bj].py;
    jets[bi].pz += jets[bj].pz;
    jets[bi].e += jets[bj].e;
    jets[bj].alive = false;
    ceta[bi] = jet_eta(jets[bi]);
    cphi[bi] = jet_phi(jets[bi]);
    double p = jet_pt(jets[bi]);
    cpt2[bi] = p * p;
    --alive_count;
  }

  // collect pt-descending
  std::vector<int> idx;
  for (int i = 0; i < n; ++i)
    if (jets[i].alive) idx.push_back(i);
  for (size_t a = 0; a < idx.size(); ++a)
    for (size_t b = a + 1; b < idx.size(); ++b)
      if (cpt2[idx[b]] > cpt2[idx[a]]) std::swap(idx[a], idx[b]);
  for (size_t a = 0; a < idx.size() && a < static_cast<size_t>(n_jets); ++a) {
    axes_eta[a] = ceta[idx[a]];
    axes_phi[a] = cphi[idx[a]];
  }
  return static_cast<int>(idx.size());
}

double nsubjettiness(const double* pt, const double* eta, const double* phi,
                     int n, const double* axes_eta, const double* axes_phi,
                     int n_axes, double beta, double R) {
  double d0 = 0.0, num = 0.0;
  for (int i = 0; i < n; ++i) d0 += pt[i] * std::pow(R, beta);
  for (int i = 0; i < n; ++i) {
    double best = 1e300;
    for (int a = 0; a < n_axes; ++a) {
      double dr2 = delta_r2(eta[i], phi[i], axes_eta[a], axes_phi[a]);
      if (dr2 < best) best = dr2;
    }
    num += pt[i] * std::pow(std::sqrt(best), beta);
  }
  return num / (d0 > 1e-30 ? d0 : 1e-30);
}

void energy_correlators(const double* pt, const double* eta, const double* phi,
                        int n, double beta, double* e2_out, double* e3_out) {
  double total = 0.0;
  for (int i = 0; i < n; ++i) total += pt[i];
  std::vector<double> z(n);
  for (int i = 0; i < n; ++i) z[i] = pt[i] / (total > 1e-30 ? total : 1e-30);

  std::vector<double> dr(static_cast<size_t>(n) * n);
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      dr[i * n + j] =
          std::pow(std::sqrt(delta_r2(eta[i], phi[i], eta[j], phi[j])), beta);

  double e2 = 0.0, e3 = 0.0;
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j) {
      double zz = z[i] * z[j] * dr[i * n + j];
      e2 += zz;
      for (int k = j + 1; k < n; ++k)
        e3 += zz * z[k] * dr[i * n + k] * dr[j * n + k];
    }
  *e2_out = e2;
  *e3_out = e3;
}

// Jets [b0, b1) of the batch; every jet is computed on its own, so a split of
// the batch over threads gives each jet the bits of a serial run.
void substructure_range(const double* pt, const double* eta, const double* phi,
                        const uint8_t* mask, int b0, int b1, int N, double R,
                        double beta, int min_constituents, double* tau1,
                        double* tau2, double* tau3, double* d2,
                        uint8_t* valid) {
  std::vector<double> jpt(N), jeta(N), jphi(N);
  std::vector<double> axes_eta(3), axes_phi(3);

  for (int b = b0; b < b1; ++b) {
    const double* rpt = pt + static_cast<size_t>(b) * N;
    const double* reta = eta + static_cast<size_t>(b) * N;
    const double* rphi = phi + static_cast<size_t>(b) * N;
    const uint8_t* rmask = mask + static_cast<size_t>(b) * N;

    int n = 0;
    for (int i = 0; i < N; ++i) {
      if (rmask[i] && rpt[i] > 0.0) {
        jpt[n] = rpt[i];
        jeta[n] = reta[i];
        jphi[n] = rphi[i];
        ++n;
      }
    }
    if (n < min_constituents) {
      valid[b] = 0;
      tau1[b] = tau2[b] = tau3[b] = d2[b] = NAN;
      continue;
    }
    valid[b] = 1;

    for (int n_ax = 1; n_ax <= 3; ++n_ax) {
      int got = exclusive_kt_axes(jpt.data(), jeta.data(), jphi.data(), n,
                                  n_ax, R, axes_eta.data(), axes_phi.data());
      double tau = (got == n_ax)
                       ? nsubjettiness(jpt.data(), jeta.data(), jphi.data(), n,
                                       axes_eta.data(), axes_phi.data(), n_ax,
                                       beta, R)
                       : NAN;
      if (n_ax == 1) tau1[b] = tau;
      if (n_ax == 2) tau2[b] = tau;
      if (n_ax == 3) tau3[b] = tau;
    }

    double e2, e3;
    energy_correlators(jpt.data(), jeta.data(), jphi.data(), n, beta, &e2, &e3);
    d2[b] = e3 / (e2 * e2 * e2 > 1e-30 ? e2 * e2 * e2 : 1e-30);
  }
}

}  // namespace

extern "C" {

// Batch substructure over padded clouds.
//   pt/eta/phi: (B, N) row-major float64; mask: (B, N) uint8
// outputs (B,) each; valid[b]=0 marks jets below min_constituents.
// Batches of more than kJetsPerThread jets are split over the machine's
// hardware threads.
void substructure_batch(const double* pt, const double* eta, const double* phi,
                        const uint8_t* mask, int B, int N, double R,
                        double beta, int min_constituents, double* tau1,
                        double* tau2, double* tau3, double* d2,
                        uint8_t* valid) {
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int n_threads = std::max(1, std::min(hw, B / kJetsPerThread));
  if (n_threads == 1) {
    substructure_range(pt, eta, phi, mask, 0, B, N, R, beta, min_constituents,
                       tau1, tau2, tau3, d2, valid);
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) {
    int b0 = static_cast<int>(static_cast<long long>(B) * t / n_threads);
    int b1 = static_cast<int>(static_cast<long long>(B) * (t + 1) / n_threads);
    threads.emplace_back(substructure_range, pt, eta, phi, mask, b0, b1, N, R,
                         beta, min_constituents, tau1, tau2, tau3, d2, valid);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
