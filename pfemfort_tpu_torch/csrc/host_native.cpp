// Copied from pfemfort_tpu/native/src/pfem_native.cpp (pfem_rcb_partition, pfem_greedy_partition, pfem_edge_cut, pfem_gen_tet_mesh, pfem_ell_pattern, pfem_samg_aggregate, pfem_ic0, pfem_write_vtk).
//
// The port's host-side loops that are sequential by nature: mesh
// partitioning (parallel/partition.py: coordinate RCB, greedy dual-graph
// k-way, edge cut), the DIA offset census and the ELL pattern + sorted
// scatter plan (assembly/pattern.py), greedy smoothed-aggregation
// (solve/amg.py), the IC(0) factorization and the single passes of its
// set-up (the DIA matrix's CSR, its lower triangle, T and T^T as padded
// ELL, the diagonal census and DIA form of a routed block: solve/ic0.py,
// solve/amg_device.py); and the native
// mesh generator and legacy-VTK writer that the standalone programs
// pfem_gentet.cpp and pfem_partition.cpp link against.  Built with the host C++ compiler at
// first use (cuda_build.py:HostLibrary, HostProgram) and called through
// ctypes (host_native.py).  The functions are the JAX package's, unchanged, so both
// packages give the same partitions, patterns, aggregates and factor bit
// for bit; the DIA offset census and the IC(0) set-up's passes are the
// port's own and give the arrays of the numpy forms they replace.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Recursive coordinate bisection.  centroids: n x dim row-major.  Splits at
// the median of the longest axis; supports non-power-of-two nparts by
// proportional splits.  Writes part ids into out[n].
// ---------------------------------------------------------------------------
static void rcb_rec(const double* c, int dim, std::vector<int64_t>& idx,
                    int64_t lo, int64_t hi, int k, int first, int32_t* out) {
  if (k == 1) {
    for (int64_t i = lo; i < hi; ++i) out[idx[i]] = first;
    return;
  }
  int k_left = k / 2;
  // longest axis over [lo, hi)
  int axis = 0;
  double best = -1.0;
  for (int d = 0; d < dim; ++d) {
    double mn = 1e300, mx = -1e300;
    for (int64_t i = lo; i < hi; ++i) {
      double v = c[idx[i] * dim + d];
      mn = std::min(mn, v);
      mx = std::max(mx, v);
    }
    if (mx - mn > best) { best = mx - mn; axis = d; }
  }
  int64_t n = hi - lo;
  int64_t n_left = (int64_t)((double)k_left / k * n + 0.5);
  std::nth_element(idx.begin() + lo, idx.begin() + lo + n_left,
                   idx.begin() + hi, [&](int64_t a, int64_t b) {
                     return c[a * dim + axis] < c[b * dim + axis];
                   });
  rcb_rec(c, dim, idx, lo, lo + n_left, k_left, first, out);
  rcb_rec(c, dim, idx, lo + n_left, hi, k - k_left, first + k_left, out);
}

void pfem_rcb_partition(const double* centroids, int64_t n, int dim,
                        int nparts, int32_t* out) {
  std::vector<int64_t> idx(n);
  std::iota(idx.begin(), idx.end(), 0);
  rcb_rec(centroids, dim, idx, 0, n, nparts, 0, out);
}

// ---------------------------------------------------------------------------
// Dual graph (elements adjacent iff sharing >= ncommon nodes) + greedy BFS
// k-way growth.  conn: n_elem x npe row-major, 0-based.
// ---------------------------------------------------------------------------
void pfem_greedy_partition(const int32_t* conn, int64_t n_elem, int npe,
                           int64_t n_node, int ncommon, int nparts,
                           int32_t* out) {
  // node -> elements CSR
  std::vector<int64_t> cnt(n_node + 1, 0);
  for (int64_t i = 0; i < n_elem * npe; ++i) cnt[conn[i] + 1]++;
  for (int64_t i = 0; i < n_node; ++i) cnt[i + 1] += cnt[i];
  std::vector<int32_t> node_elems(n_elem * npe);
  {
    std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
    for (int64_t e = 0; e < n_elem; ++e)
      for (int p = 0; p < npe; ++p)
        node_elems[pos[conn[e * npe + p]]++] = (int32_t)e;
  }
  // adjacency via shared-node counting per element
  std::vector<std::vector<int32_t>> adj(n_elem);
  std::vector<int16_t> shared(n_elem, 0);
  std::vector<int32_t> touched;
  for (int64_t e = 0; e < n_elem; ++e) {
    touched.clear();
    for (int p = 0; p < npe; ++p) {
      int32_t nd = conn[e * npe + p];
      for (int64_t k = cnt[nd]; k < cnt[nd + 1]; ++k) {
        int32_t o = node_elems[k];
        if (o == (int32_t)e) continue;
        if (shared[o]++ == 0) touched.push_back(o);
      }
    }
    for (int32_t o : touched) {
      if (shared[o] >= ncommon) adj[e].push_back(o);
      shared[o] = 0;
    }
  }
  // greedy BFS growth; when a part's frontier dries up before reaching its
  // target size, reseed from the next unassigned element so parts stay
  // balanced even across disconnected pockets.
  int64_t target = (n_elem + nparts - 1) / nparts;
  std::fill(out, out + n_elem, -1);
  int64_t seed_scan = 0;
  for (int p = 0; p < nparts; ++p) {
    std::queue<int32_t> q;
    int64_t size = 0;
    while (size < target) {
      if (q.empty()) {
        while (seed_scan < n_elem && out[seed_scan] != -1) ++seed_scan;
        if (seed_scan >= n_elem) break;
        q.push((int32_t)seed_scan);
      }
      int32_t e = q.front();
      q.pop();
      if (out[e] != -1) continue;
      out[e] = p;
      ++size;
      for (int32_t o : adj[e])
        if (out[o] == -1) q.push(o);
    }
  }
  for (int64_t e = 0; e < n_elem; ++e)
    if (out[e] == -1) out[e] = nparts - 1;
}

// Edge-cut of an element partition (quality metric, like METIS's objval).
int64_t pfem_edge_cut(const int32_t* conn, int64_t n_elem, int npe,
                      int64_t n_node, int ncommon, const int32_t* part) {
  std::vector<int64_t> cnt(n_node + 1, 0);
  for (int64_t i = 0; i < n_elem * npe; ++i) cnt[conn[i] + 1]++;
  for (int64_t i = 0; i < n_node; ++i) cnt[i + 1] += cnt[i];
  std::vector<int32_t> node_elems(n_elem * npe);
  {
    std::vector<int64_t> pos(cnt.begin(), cnt.end() - 1);
    for (int64_t e = 0; e < n_elem; ++e)
      for (int p = 0; p < npe; ++p)
        node_elems[pos[conn[e * npe + p]]++] = (int32_t)e;
  }
  std::vector<int16_t> shared(n_elem, 0);
  std::vector<int32_t> touched;
  int64_t cut = 0;
  for (int64_t e = 0; e < n_elem; ++e) {
    touched.clear();
    for (int p = 0; p < npe; ++p) {
      int32_t nd = conn[e * npe + p];
      for (int64_t k = cnt[nd]; k < cnt[nd + 1]; ++k) {
        int32_t o = node_elems[k];
        if (o <= (int32_t)e) continue;
        if (shared[o]++ == 0) touched.push_back(o);
      }
    }
    for (int32_t o : touched) {
      if (shared[o] >= ncommon && part[e] != part[o]) ++cut;
      shared[o] = 0;
    }
  }
  return cut;
}

// ---------------------------------------------------------------------------
// ELL sparsity pattern + sorted scatter plan from element DOF rows.
//
// Native counterpart of the reference's MatSetValues sparsity pre-pass
// (triapoissonparallelimpl1.F:814-825): dedupe the E*ns*ns element entry
// (row, col) pairs into CSR + padded ELL, and emit the stable sorted
// scatter permutation/segment ids the device segment-sum assembly uses.
// Row-bucket counting sort over packed (col << 32 | entry) keys replaces
// the earlier 3-pass LSD radix: ONE histogram stream over elem_dof + ONE
// bucketed scatter + per-row local sorts (rows hold ~K entries, cache
// resident).  On this 2-core box the radix spent 3 full scattered passes
// over 12 B/entry; this does one pass over 8 B/entry (80 s -> ~25 s at
// the 393M-entry 24.6M-element stage).  Entry index within the packed
// key makes plain sort() reproduce the stable order exactly (ties in
// (row, col) keep ascending entry order, byte-identical to numpy's
// kind="stable" argsort of row*n+col keys).
//
// Entry t = (i*ns + j)*n_elem + e matches the (ns, ns, E) element-minor Ke
// flattening (assembly/pattern.py:_entry_arrays).  Invalid entries (either
// DOF eliminated, sentinel -1) land in a final bucket in entry order and
// map to segment n_rows*K.
//
// Outputs (caller-allocated): mat_perm[n_ent] i32, mat_segids[n_ent] i32
// (non-decreasing), indptr[n_rows+1] i64, indices[>=nnz] i32, k_out = ELL
// slot count.  Returns nnz, or -1 when int32 ranges would overflow
// (callers fall back to the numpy builder).
// ---------------------------------------------------------------------------
int64_t pfem_ell_pattern(const int32_t* elem_dof, int64_t n_elem, int32_t ns,
                         int64_t n_rows, int32_t lane_pad, int32_t* mat_perm,
                         int32_t* mat_segids, int64_t* indptr,
                         int32_t* indices, int32_t* k_out) {
  const int64_t n_ent = n_elem * (int64_t)ns * ns;
  if (n_ent >= (int64_t)INT32_MAX) return -1;
  if (n_rows >= (int64_t)INT32_MAX) return -1;

  // pass 1: per-row entry counts (bucket n_rows = invalid), 2 threads on
  // disjoint (i, j) halves with private histograms
  std::vector<int64_t> h0(n_rows + 1, 0), h1(n_rows + 1, 0);
  auto count = [&](std::vector<int64_t>& h, int32_t p0, int32_t p1) {
    for (int32_t p = p0; p < p1; ++p) {
      const int32_t i = p / ns, j = p % ns;
      for (int64_t e = 0; e < n_elem; ++e) {
        const int32_t r = elem_dof[e * ns + i];
        const int32_t c = elem_dof[e * ns + j];
        h[(r >= 0 && c >= 0) ? r : n_rows]++;
      }
    }
  };
  {
    const int32_t np = ns * ns;
    std::thread th(count, std::ref(h0), 0, np / 2);
    count(h1, np / 2, np);
    th.join();
  }
  std::vector<int64_t> startv(n_rows + 2);
  startv[0] = 0;
  for (int64_t r = 0; r <= n_rows; ++r)
    startv[r + 1] = startv[r] + h0[r] + h1[r];

  // pass 2: bucketed scatter of packed (col << 32 | t) keys, SINGLE
  // thread (cursor array is shared; entry order within a bucket must be
  // ascending t for stability)
  std::vector<uint64_t> pk(n_ent);
  std::vector<int64_t> cur(startv.begin(), startv.begin() + n_rows + 2);
  for (int32_t p = 0; p < ns * ns; ++p) {
    const int32_t i = p / ns, j = p % ns;
    const int64_t tbase = (int64_t)p * n_elem;
    for (int64_t e = 0; e < n_elem; ++e) {
      const int32_t r = elem_dof[e * ns + i];
      const int32_t c = elem_dof[e * ns + j];
      const int64_t row = (r >= 0 && c >= 0) ? r : n_rows;
      const uint32_t col = (row == n_rows) ? 0xFFFFFFFFu : (uint32_t)c;
      pk[cur[row]++] = ((uint64_t)col << 32) | (uint32_t)(tbase + e);
    }
  }

  // pass 3: per-row sorts (plain sort: the entry id in the low bits makes
  // equal-(row,col) runs keep ascending entry order), 2 threads on row
  // halves; the invalid bucket stays in entry order (all "keys" equal)
  {
    auto sort_rows = [&](int64_t r0, int64_t r1) {
      for (int64_t r = r0; r < r1; ++r)
        std::sort(pk.begin() + startv[r], pk.begin() + startv[r + 1]);
    };
    const int64_t rh = n_rows / 2;
    std::thread th(sort_rows, 0, rh);
    sort_rows(rh, n_rows);
    th.join();
  }

  const int64_t nvalid = startv[n_rows];

  // pass 4: unique (row, col) -> indices + per-row degrees
  std::memset(indptr, 0, sizeof(int64_t) * (n_rows + 1));
  int64_t nnz = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    uint32_t prev = 0xFFFFFFFFu;
    bool first = true;
    for (int64_t t = startv[r]; t < startv[r + 1]; ++t) {
      const uint32_t c = (uint32_t)(pk[t] >> 32);
      if (first || c != prev) {
        first = false;
        prev = c;
        indptr[r + 1]++;
        indices[nnz++] = (int32_t)c;
      }
    }
  }
  int64_t max_deg = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    max_deg = std::max(max_deg, indptr[r + 1]);
    indptr[r + 1] += indptr[r];
  }
  const int64_t K =
      ((std::max(max_deg, (int64_t)1)) + lane_pad - 1) / lane_pad * lane_pad;
  if (n_rows * K + 1 >= (int64_t)INT32_MAX) return -1;
  *k_out = (int32_t)K;

  // pass 5: sorted segment ids (ELL-flat, monotone) + permutation
  const int32_t dropped = (int32_t)(n_rows * K);
  {
    int64_t t = 0;
    for (int64_t r = 0; r < n_rows; ++r) {
      uint32_t prev = 0xFFFFFFFFu;
      bool first = true;
      int64_t within = -1;
      for (int64_t q = startv[r]; q < startv[r + 1]; ++q, ++t) {
        const uint32_t c = (uint32_t)(pk[q] >> 32);
        if (first || c != prev) {
          first = false;
          prev = c;
          ++within;
        }
        mat_segids[t] = (int32_t)(r * K + within);
        mat_perm[t] = (int32_t)(uint32_t)pk[q];
      }
    }
    for (int64_t q = nvalid; q < n_ent; ++q, ++t) {
      mat_segids[t] = dropped;
      mat_perm[t] = (int32_t)(uint32_t)pk[q];
    }
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// DIA offset census (the port's own; assembly/pattern.py:build_pattern):
// the distinct diagonal offsets (col - row) over every valid (row, col) pair
// of every element, in one pass over each element's dof pairs into a byte
// table of 2*n_rows + 1 entries indexed by offset + n_rows.  The pairs i < j
// mark d = b - a, any valid dof marks 0, and the table is then made
// symmetric (the ordered pair (b, a) gives -d), so each pair is read once
// and no entry array is made.  Writes the offsets in ascending order to out
// (caller-allocated, >= 2*n_rows - 1 entries) and returns how many; -1 when
// n_rows overflows int32 or a dof lies outside [-1, n_rows).
// ---------------------------------------------------------------------------
int64_t pfem_offset_census(const int32_t* elem_dof, int64_t n_elem,
                           int32_t ns, int64_t n_rows, int64_t* out) {
  if (n_rows >= (int64_t)INT32_MAX) return -1;
  const int64_t n_slot = n_elem * ns;
  for (int64_t t = 0; t < n_slot; ++t)
    if (elem_dof[t] < -1 || elem_dof[t] >= n_rows) return -1;
  std::vector<uint8_t> seen(2 * n_rows + 1, 0);
  uint8_t* const mid = seen.data() + n_rows;
  for (int64_t e = 0; e < n_elem; ++e) {
    const int32_t* d = elem_dof + e * ns;
    for (int32_t i = 0; i < ns; ++i) {
      const int32_t a = d[i];
      if (a < 0) continue;
      mid[0] = 1;
      for (int32_t j = i + 1; j < ns; ++j) {
        const int32_t b = d[j];
        if (b < 0) continue;
        mid[b - a] = 1;
      }
    }
  }
  for (int64_t k = 1; k <= n_rows; ++k)
    mid[k] = mid[-k] = mid[k] | mid[-k];
  int64_t n = 0;
  for (int64_t k = 0; k <= 2 * n_rows; ++k)
    if (seen[k]) out[n++] = k - n_rows;
  return n;
}


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
//
// The sparse dot of row i's prefix with row k's strict prefix walks row k
// and finds row i's entry of each column through a position map of row i
// (the port's form of the JAX package's two-pointer merge): the same
// products added in the same ascending column order, so the same factor
// bit for bit on rows without repeated columns, with no branch on the
// merge's comparisons.
// ---------------------------------------------------------------------------
int64_t pfem_ic0(int64_t n, const int64_t* lp, const int32_t* li,
                 double* lv) {
  int64_t fixups = 0;
  // row i's place (from r0) of each of its columns; UINT32_MAX elsewhere
  std::vector<uint32_t> pos(n, UINT32_MAX);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r0 = lp[i], r1 = lp[i + 1];
    for (int64_t p = r0; p < r1; ++p) pos[li[p]] = (uint32_t)(p - r0);
    double dsum = 0.0;
    for (int64_t p = r0; p < r1; ++p) {
      const int32_t k = li[p];
      if (k < i) {
        // sparse dot of row i's prefix [r0, p) with row k's strict prefix
        double s = 0.0;
        const int64_t bdiag = lp[k + 1] - 1;
        const uint32_t before = (uint32_t)(p - r0);
        for (int64_t b = lp[k]; b < bdiag; ++b) {
          // no branch: a miss adds +0.0, which leaves s's bits (never -0.0)
          const uint32_t a = pos[li[b]];
          const bool hit = a < before;
          const double prod = lv[r0 + (hit ? a : 0)] * lv[b];
          s += hit ? prod : 0.0;
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
    for (int64_t p = r0; p < r1; ++p) pos[li[p]] = UINT32_MAX;
  }
  return fixups;
}

}  // extern "C"

// Runs f(lo, hi) on contiguous chunks of [0, n), one thread each: the
// host's cores up to 8, one chunk below 2^16 rows.
template <class F>
static void for_row_chunks(int64_t n, F f) {
  int64_t nt = std::min<int64_t>(8, std::thread::hardware_concurrency());
  if (nt < 1 || n < (1 << 16)) nt = 1;
  std::vector<std::thread> ts;
  for (int64_t t = 1; t < nt; ++t)
    ts.emplace_back(f, n * t / nt, n * (t + 1) / nt);
  f(0, n / nt);
  for (auto& th : ts) th.join();
}

extern "C" {

// ---------------------------------------------------------------------------
// The IC(0) set-up's passes over the host arrays (solve/ic0.py,
// solve/amg_device.py), each in the order the numpy forms they replace
// would give, so the arrays are the same bit for bit; the row-wise passes
// run on row chunks in threads (for_row_chunks).
//
// pfem_dia_to_csr: the CSR of a (D, n) DIA value array, its diagonals
// visited in the order `ord` (the offsets ascending), so each row's columns
// come out ascending without a sort; stored entries inside the matrix are
// kept whatever their value.  indptr (n + 1) and indices / vals (the count
// of in-range entries) are the caller's.  Returns that count.
// ---------------------------------------------------------------------------
int64_t pfem_dia_to_csr(int64_t n, int64_t n_diag, const int64_t* offsets,
                        const int64_t* ord, const double* dvals,
                        int64_t* indptr, int32_t* indices, double* vals) {
  indptr[0] = 0;
  for_row_chunks(n, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t deg = 0;
      for (int64_t d = 0; d < n_diag; ++d)
        deg += (r + offsets[d] >= 0 && r + offsets[d] < n);
      indptr[r + 1] = deg;
    }
  });
  for (int64_t r = 0; r < n; ++r) indptr[r + 1] += indptr[r];
  for_row_chunks(n, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t p = indptr[r];
      for (int64_t k = 0; k < n_diag; ++k) {
        const int64_t d = ord[k];
        const int64_t c = r + offsets[d];
        if (c < 0 || c >= n) continue;
        indices[p] = (int32_t)c;
        vals[p] = dvals[d * n + r];
        ++p;
      }
    }
  });
  return indptr[n];
}

// pfem_csr_lower: the entries of a CSR with column <= row, in their order.
// With li == nullptr it writes lp (n + 1) alone; given li and lv it fills
// them from the lp that call wrote.  Returns the entry count.
int64_t pfem_csr_lower(int64_t n, const int64_t* indptr,
                       const int32_t* indices, const double* vals,
                       int64_t* lp, int32_t* li, double* lv) {
  if (li == nullptr) {
    lp[0] = 0;
    for_row_chunks(n, [&](int64_t lo, int64_t hi) {
      for (int64_t r = lo; r < hi; ++r) {
        int64_t q = 0;
        for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p)
          q += (indices[p] <= r);
        lp[r + 1] = q;
      }
    });
    for (int64_t r = 0; r < n; ++r) lp[r + 1] += lp[r];
    return lp[n];
  }
  for_row_chunks(n, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      int64_t q = lp[r];
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        if (indices[p] > r) continue;
        li[q] = indices[p];
        lv[q] = vals[p];
        ++q;
      }
    }
  });
  return lp[n];
}

// pfem_ic0_degrees: the entries of T = D^-1 L - I (those of the factor's
// rows with column < row) per row (tdeg) and per column (ttdeg, the rows of
// T^T); both zeroed by the caller.  Returns T's entry count.
int64_t pfem_ic0_degrees(int64_t n, const int64_t* lp, const int32_t* li,
                         int64_t* tdeg, int64_t* ttdeg) {
  int64_t nnz = 0;
  for (int64_t r = 0; r < n; ++r) {
    for (int64_t p = lp[r]; p < lp[r + 1]; ++p) {
      if (li[p] >= r) continue;
      ++tdeg[r];
      ++ttdeg[li[p]];
      ++nnz;
    }
  }
  return nnz;
}

// pfem_ic0_ell: T and T^T as padded ELL (kt / ktt slots a row, column n
// and value 0 in the padding): T[r, c] = lv * dinv[r] in the factor's
// order, and each column's entries in T^T in ascending row order, the
// order of a stable sort of T's entries by column.
void pfem_ic0_ell(int64_t n, const int64_t* lp, const int32_t* li,
                  const double* lv, const double* dinv, int64_t kt,
                  int32_t* t_cols, double* t_vals, int64_t ktt,
                  int32_t* tt_cols, double* tt_vals) {
  for_row_chunks(n, [&](int64_t lo, int64_t hi) {
    std::fill(t_cols + lo * kt, t_cols + hi * kt, (int32_t)n);
    std::fill(t_vals + lo * kt, t_vals + hi * kt, 0.0);
    std::fill(tt_cols + lo * ktt, tt_cols + hi * ktt, (int32_t)n);
    std::fill(tt_vals + lo * ktt, tt_vals + hi * ktt, 0.0);
    for (int64_t r = lo; r < hi; ++r) {
      int64_t w = r * kt;
      for (int64_t p = lp[r]; p < lp[r + 1]; ++p) {
        if (li[p] >= r) continue;
        t_cols[w] = li[p];
        t_vals[w] = lv[p] * dinv[r];
        ++w;
      }
    }
  });
  std::vector<int64_t> fill(n, 0);
  for (int64_t r = 0; r < n; ++r) {
    for (int64_t p = lp[r]; p < lp[r + 1]; ++p) {
      const int32_t c = li[p];
      if (c >= r) continue;
      const int64_t s = (int64_t)c * ktt + fill[c]++;
      tt_cols[s] = (int32_t)r;
      tt_vals[s] = lv[p] * dinv[r];
    }
  }
}

// pfem_ell_offset_counts: the slots of an (n, k) ELL column array whose
// column lies below n, by diagonal c - r + n - 1 (counts: 2n - 1, zeroed
// by the caller).
void pfem_ell_offset_counts(int64_t n, int64_t k, const int32_t* cols,
                            int64_t* counts) {
  for (int64_t r = 0; r < n; ++r)
    for (int64_t j = 0; j < k; ++j) {
      const int64_t c = cols[r * k + j];
      if (c >= 0 && c < n) ++counts[c - r + n - 1];
    }
}

// pfem_ell_to_dia: the (D, n) DIA values of an (n, k) ELL block, given the
// diagonal index of each offset (dia_of: 2n - 1, -1 where absent); dvals
// (n_diag * n) is zeroed here and each slot's value added to its place in
// slot order.  Returns -1 when an in-range slot lies on an absent offset,
// else 0.
int64_t pfem_ell_to_dia(int64_t n, int64_t k, int64_t n_diag,
                        const int32_t* cols, const double* vals,
                        const int32_t* dia_of, double* dvals) {
  std::atomic<bool> bad(false);
  for_row_chunks(n, [&](int64_t lo, int64_t hi) {
    for (int64_t d = 0; d < n_diag; ++d)
      std::fill(dvals + d * n + lo, dvals + d * n + hi, 0.0);
    int64_t miss = 0;
    for (int64_t r = lo; r < hi; ++r)
      for (int64_t j = 0; j < k; ++j) {
        const int64_t c = cols[r * k + j];
        if (c < 0 || c >= n) continue;
        const int32_t d = dia_of[c - r + n - 1];
        if (d < 0) {
          ++miss;
          continue;
        }
        dvals[(int64_t)d * n + r] += vals[r * k + j];
      }
    if (miss) bad = true;
  });
  return bad ? -1 : 0;
}

// ---------------------------------------------------------------------------
// Box -> 6-tet mesh generation (same lattice, split and boundary-BC field as
// the reference generator; values u = x^2+y^2+z^2 from real coordinates).
// Writes <prefix>-nodes.dat / -elems.dat / -DirichBC.dat (1-based).
// Returns 0 on success.
// ---------------------------------------------------------------------------
int pfem_gen_tet_mesh(double x0, double x1, int64_t nex, double y0, double y1,
                      int64_t ney, double z0, double z1, int64_t nez,
                      const char* prefix) {
  const int64_t nnx = nex + 1, nny = ney + 1, nnz = nez + 1;
  const double dx = (x1 - x0) / nex, dy = (y1 - y0) / ney,
               dz = (z1 - z0) / nez;
  char path[4096];

  snprintf(path, sizeof path, "%s-nodes.dat", prefix);
  FILE* f = fopen(path, "w");
  if (!f) return 1;
  int64_t ind = 1;
  for (int64_t k = 0; k < nnz; ++k)
    for (int64_t j = 0; j < nny; ++j)
      for (int64_t i = 0; i < nnx; ++i)
        fprintf(f, "%lld\t%.8f\t%.8f\t%.8f\n", (long long)ind++, x0 + i * dx,
                y0 + j * dy, z0 + k * dz);
  fclose(f);

  snprintf(path, sizeof path, "%s-elems.dat", prefix);
  f = fopen(path, "w");
  if (!f) return 1;
  const int split[6][4] = {{0, 1, 3, 5}, {0, 3, 2, 5}, {2, 3, 7, 5},
                           {4, 6, 7, 2}, {4, 7, 5, 2}, {0, 4, 5, 2}};
  int64_t cell = 1;
  for (int64_t k = 0; k < nez; ++k)
    for (int64_t j = 0; j < ney; ++j)
      for (int64_t i = 0; i < nex; ++i) {
        int64_t base = k * nnx * nny + j * nnx + i;
        int64_t pts[8] = {base,
                          base + 1,
                          base + nnx,
                          base + nnx + 1,
                          base + nnx * nny,
                          base + nnx * nny + 1,
                          base + nnx * nny + nnx,
                          base + nnx * nny + nnx + 1};
        for (int t = 0; t < 6; ++t)
          fprintf(f, "%lld\t%lld\t%lld\t%lld\t%lld\n", (long long)cell++,
                  (long long)(pts[split[t][0]] + 1),
                  (long long)(pts[split[t][1]] + 1),
                  (long long)(pts[split[t][2]] + 1),
                  (long long)(pts[split[t][3]] + 1));
      }
  fclose(f);

  snprintf(path, sizeof path, "%s-DirichBC.dat", prefix);
  f = fopen(path, "w");
  if (!f) return 1;
  for (int64_t k = 0; k < nnz; ++k)
    for (int64_t j = 0; j < nny; ++j)
      for (int64_t i = 0; i < nnx; ++i) {
        if (i != 0 && i != nex && j != 0 && j != ney && k != 0 && k != nez)
          continue;
        double x = x0 + i * dx, y = y0 + j * dy, z = z0 + k * dz;
        int64_t node = k * nnx * nny + j * nnx + i + 1;
        fprintf(f, "%lld\t1\t%.8f\n", (long long)node,
                x * x + y * y + z * z);
      }
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Legacy-VTK writer (layout of writervtk.F): cells + procid + nodal solution.
// coords: n_node x 3 (z = 0 for 2D), conn: n_elem x npe 0-based, soln may be
// null.  vtk_type per writervtk.F:100-166.
// ---------------------------------------------------------------------------
int pfem_write_vtk(const char* path, int64_t n_node, const double* coords,
                   int64_t n_elem, int npe, const int32_t* conn, int vtk_type,
                   const int32_t* procid, int ndof, const double* soln) {
  FILE* f = fopen(path, "w");
  if (!f) return 1;
  fprintf(f, "# vtk DataFile Version 4.0\n");
  fprintf(f, "pfemfort_tpu native output\n");
  fprintf(f, " ASCII\n");
  fprintf(f, "DATASET UNSTRUCTURED_GRID\n");
  fprintf(f, "POINTS %10lld float\n", (long long)n_node);
  for (int64_t i = 0; i < n_node; ++i)
    fprintf(f, "%12.6f%12.6f%12.6f\n", coords[i * 3], coords[i * 3 + 1],
            coords[i * 3 + 2]);
  fprintf(f, "CELLS %10lld%10lld\n", (long long)n_elem,
          (long long)(n_elem * (npe + 1)));
  for (int64_t e = 0; e < n_elem; ++e) {
    fprintf(f, "%10d", npe);
    for (int p = 0; p < npe; ++p) fprintf(f, "%10d", conn[e * npe + p]);
    fprintf(f, "\n");
  }
  fprintf(f, "CELL_TYPES%10lld\n", (long long)n_elem);
  for (int64_t e = 0; e < n_elem; ++e) fprintf(f, "%3d\n", vtk_type);
  fprintf(f, "CELL_DATA%10lld\n", (long long)n_elem);
  fprintf(f, "SCALARS procid int 1\nLOOKUP_TABLE default\n");
  for (int64_t e = 0; e < n_elem; ++e)
    fprintf(f, "%3d\n", procid ? procid[e] : 0);
  if (soln) {
    fprintf(f, "POINT_DATA%10lld\n", (long long)n_node);
    if (ndof == 1) {
      fprintf(f, "SCALARS solution float 1\nLOOKUP_TABLE default\n");
      for (int64_t i = 0; i < n_node; ++i) fprintf(f, "%12.6f\n", soln[i]);
    } else {
      fprintf(f, "VECTORS solution float\n");
      for (int64_t i = 0; i < n_node; ++i) {
        double v[3] = {0, 0, 0};
        for (int d = 0; d < ndof && d < 3; ++d) v[d] = soln[i * ndof + d];
        fprintf(f, "%12.6f%12.6f%12.6f\n", v[0], v[1], v[2]);
      }
    }
  }
  fclose(f);
  return 0;
}

}  // extern "C"
