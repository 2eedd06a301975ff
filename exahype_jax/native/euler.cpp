// Compressible-Euler physics for natively compiled generated kernels.
//
// Native counterpart of exahype_jax/models/euler.py, used by the C++-backend
// differential tests (the role the reference's physics fixture plays for its
// harness, `Unit test/Functions.cpp:9-62`).  Parametric over dimensionality
// and variable count via -DEXA_DIM / -DEXA_NREAL at compile time.
//
// State convention: Q = [rho, m_x, m_y, (m_z,) E, aux...].

#include <cmath>

#ifndef EXA_DIM
#define EXA_DIM 2
#endif
#ifndef EXA_NREAL
#define EXA_NREAL 5
#endif

namespace {
constexpr double kGamma = 1.4;

inline double pressure_of(const double* Q) {
  double kinetic = Q[1] * Q[1] + Q[2] * Q[2];
#if EXA_DIM == 3
  kinetic += Q[3] * Q[3];
#endif
  const double e = Q[EXA_DIM + 1];
  return (kGamma - 1.0) * (e - 0.5 * (1.0 / Q[0]) * kinetic);
}
}  // namespace

int Flux(const double* Q, double normal, double* F) {
  const int n = static_cast<int>(normal);
  const double inv_rho = 1.0 / Q[0];
  const double p = pressure_of(Q);
  const double coeff = inv_rho * Q[n + 1];
  for (int k = 0; k < EXA_DIM + 1; ++k) {
    F[k] = coeff * Q[k];
  }
  F[n + 1] = F[n + 1] + p;
  F[EXA_DIM + 1] = coeff * Q[EXA_DIM + 1] + coeff * p;
  for (int k = EXA_DIM + 2; k < EXA_NREAL; ++k) {
    F[k] = 0.0;
  }
  return 0;
}

double maxEigenvalue(const double* Q, double normal) {
  const int n = static_cast<int>(normal);
  const double inv_rho = 1.0 / std::abs(Q[0]);
  const double p = pressure_of(Q);
  const double c = std::sqrt(kGamma * std::abs(p) * inv_rho);
  const double u_n = Q[n + 1] * inv_rho;
  const double lo = std::abs(u_n - c);
  const double hi = std::abs(u_n + c);
  return lo > hi ? lo : hi;
}

double max(const double* a, const double* b) { return *a > *b ? *a : *b; }
