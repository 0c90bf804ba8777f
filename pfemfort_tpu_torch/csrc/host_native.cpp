// Copied from pfemfort_tpu/native/src/pfem_native.cpp (pfem_samg_aggregate, pfem_ic0).
//
// Host-side set-up loops of the port's algebraic preconditioners, the two
// that are sequential by nature: greedy smoothed-aggregation (solve/amg.py)
// and the IC(0) factorization (solve/ic0.py).  Built with the host C++
// compiler at first use (cuda_build.py:HostLibrary) and called through
// ctypes (host_native.py).  The functions are the JAX package's, unchanged,
// so both packages give the same aggregates and the same factor bit for bit.

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" {

// ---------------------------------------------------------------------------
// Smoothed-aggregation greedy root aggregation (solve/amg.py host setup):
// pass 1 roots with fully-unaggregated strong neighborhoods, pass 2 attach
// leftovers to a neighboring aggregate, pass 3 singletons.  Returns n_agg.
// ---------------------------------------------------------------------------
int64_t pfem_samg_aggregate(int64_t n, const int64_t* sp, const int32_t* si,
                            int64_t* agg) {
  std::fill(agg, agg + n, (int64_t)-1);
  int64_t n_agg = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    bool free_nb = true;
    for (int64_t p = sp[i]; p < sp[i + 1]; ++p)
      if (agg[si[p]] >= 0) {
        free_nb = false;
        break;
      }
    if (!free_nb) continue;
    agg[i] = n_agg;
    for (int64_t p = sp[i]; p < sp[i + 1]; ++p) agg[si[p]] = n_agg;
    ++n_agg;
  }
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    for (int64_t p = sp[i]; p < sp[i + 1]; ++p)
      if (agg[si[p]] >= 0) {
        agg[i] = agg[si[p]];
        break;
      }
  }
  for (int64_t i = 0; i < n; ++i)
    if (agg[i] < 0) agg[i] = n_agg++;
  return n_agg;
}

// ---------------------------------------------------------------------------
// IC(0): incomplete Cholesky on the lower-triangular pattern, in place.
//
// lp/li/lv: CSR of the LOWER triangle including the diagonal, columns
// ascending per row (so the diagonal is each row's LAST entry).  lv is
// overwritten with the factor.  Rows with non-positive pivots get a small
// positive substitute (breakdown guard; the preconditioner stays SPD).
// Returns the number of pivot substitutions.
// ---------------------------------------------------------------------------
int64_t pfem_ic0(int64_t n, const int64_t* lp, const int32_t* li,
                 double* lv) {
  int64_t fixups = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r0 = lp[i], r1 = lp[i + 1];
    double dsum = 0.0;
    for (int64_t p = r0; p < r1; ++p) {
      const int32_t k = li[p];
      if (k < i) {
        // sparse dot of row i's prefix [r0, p) with row k's strict prefix
        double s = 0.0;
        int64_t a = r0, b = lp[k];
        const int64_t bdiag = lp[k + 1] - 1;
        while (a < p && b < bdiag) {
          const int32_t ca = li[a], cb = li[b];
          if (ca == cb) {
            s += lv[a] * lv[b];
            ++a;
            ++b;
          } else if (ca < cb) {
            ++a;
          } else {
            ++b;
          }
        }
        lv[p] = (lv[p] - s) / lv[bdiag];
        dsum += lv[p] * lv[p];
      } else {
        double d = lv[p] - dsum;
        if (!(d > 0.0)) {
          d = (lv[p] > 0.0) ? lv[p] : 1.0;  // breakdown guard
          ++fixups;
        }
        lv[p] = std::sqrt(d);
      }
    }
  }
  return fixups;
}

}  // extern "C"
