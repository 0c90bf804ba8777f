// The explicit central-difference step for Hopper (sm_90a), kernel B3: two
// passes a step.
//
//   element pass   Fe[e, i, c] = dens * w_i b_c - sum_g sum_s dvol_g B^T sigma
//                  from the element's displacements, gathered through its
//                  node ids from the full vector u (node-major, component-fast)
//   node pass      rhs = sum of the node's Fe entries, in one fixed order, + fext
//                  rhs += M (2 u - u_prev) / dt^2
//                  u_new = upd ? dt^2 rhs / M : 0
//                  v = (u_new - u_prev) / (2 dt)
//                  or, for the hourglass quad4 (B3_HG), the same step in
//                  velocity form, from the half-step velocity w = v^{n-1/2}:
//                  w_new = upd ? w + dt (rhs / M) : 0
//                  u_new = upd ? u + dt w_new : 0
//                  v = (w + w_new) / 2
//
// It replaces no TPU kernel: the JAX package's time loop
// (pfemfort_tpu/dynamics/explicit.py) is a lax.scan of XLA ops.  The port's
// plain form of the same step (dynamics/explicit.py with
// elements/elasticity.py:apply_residual and assembly/assemble.py:Segments)
// runs some forty kernels a step, reads a precomputed dvol * B of 36 values
// an element, writes Fint six times, gathers with int64 indices and sums
// ~23-entry segments through cub's segmented reduce.  The CPU keeps it.
//
// Bound: device memory.  At the 1.57M-element tetra4 box in float32 the step
// has to read the node ids (4 int32 an element), gradN (12 values), dvol, the
// node pass's plan (4 int32 an element and an offset a node), the mass and
// the state vectors, and to write and read Fe (12 values an element) once:
// 186 MB in the element pass and 122 MB in the node pass, ~92 us at
// 3.35 TB/s.  It does ~200 flops an element.  The design, from that:
//
//  * Nothing of the geometry but gradN and dvol.  The element pass forms grad
//    u, the tensorial strain, the stress (D's isotropic pattern, the values
//    by value in the launch parameters) and B^T sigma in registers; dvol * B
//    is never formed.  The node weights w_i = sum_g N[g, i] dvol_g come from
//    dvol and the basis values at the Gauss points (launch parameters).
//  * One thread an element.  gradN and dvol are element-minor, so every load
//    of a warp is 32 neighbouring values.  The displacements are gathered
//    from the full vector (3.3 MB at the box, L2-resident) through the int32
//    node ids.  The body force is read through a device pointer, so a
//    bforce_fn(t) pulse costs no host synchronise.
//  * Fe element-major, written through shared memory: each block stages its
//    elements' NS values (padded to NS + 1 against bank conflicts) and
//    writes them out as one contiguous run.
//  * One thread a dof in the node pass, a node's components on neighbouring
//    threads.  Every component of a node sums its entries in the same
//    order, so one int32 entry a (node, element, slot) incidence serves all
//    of them: it is the Fe index of component 0, and component c is the
//    next value.  A node's threads read the same entry (one request)
//    and, Fe being element-major, neighbouring Fe values (one sector).  The
//    elements of neighbouring nodes are neighbours too on a numbered mesh,
//    so the gathers stay within a few MB of Fe at a time.  The entries go
//    in batches of kBatch, their loads issued before their adds, as in B1.
//    (Staging a block's entries in shared memory by coalesced loads gained
//    3% of the pass at the 1.57M-element box: not kept.)
//  * The update in the same read: the node pass reads u, u_prev, M, upd and
//    fext once and writes u_new and v (in velocity form it reads w for
//    u_prev and writes w_new as well).
//
// Why the hourglass quad4 takes the velocity form: its plate deflects by
// tens of thousands of times a step's motion, and the displacement form
// keeps the velocity only as u_new - u_prev, which float32 rounds to
// ulp(u) / dt a step; carried as w, the velocity keeps its own precision.
// The two forms are the same step in exact arithmetic.
//
// Summation orders.  The element pass keeps apply_residual's: grad u over
// the nodes i ascending, Fint over g outer and the Voigt rows s inner, the
// node weights over g.  The node pass sums a dof's entries in the order of
// the stable sort that Segments.from_dest makes (element slot, then
// element), which the plan (dynamics/explicit_cuda.py:node_plan_from_conn)
// carries over.  Each product and sum is rounded where the plain step's
// torch ops round it (`mul`, `fused` below), so the card gives the CPU's bits
// for the same inputs; the host side sums the lumped mass in the same order
// (explicit_cuda.py:ordered_summer), so a whole run gives the plain CPU run's
// bits.  Nothing crosses threads and there are no atomics, so a launch
// gives the same bits every time.
//
// The hourglass quad4 (B3_HG=1: the reference's ResidualElasticityLinearQuadHG,
// elements/elasticity.py:quad_hg_residual) is an element pass of its own:
// one Gauss point at the centre, the closed-form midpoint gradients
// (dN/dx = a0, a1, -a0, -a1 and dN/dy = c0, c1, -c0, -c1, with the area:
// five values an element, made once at set-up by
// elasticity.py:quad_hg_geometry), the plane-stress stress of the
// tensorial shear strain, the body force dens dvol / 4 b, and the viscous
// hourglass force -hg sqrt|A| (Gamma . v) Gamma with Gamma = (1, -1, 1, -1),
// which gathers the velocities as well.  Its sums keep quad_hg_residual's
// order (the four nodes ascending, D's nonzero terms from zero, the
// hourglass sum left to right), so it too gives the CPU's bits.  Fe is
// written as the other element pass writes it, so the node pass sums it in
// the same order; its update is the velocity form (above).
//
// One library per element shape and type: the build defines B3_NPE (nodes
// an element), B3_NDIM (dimensions, and dofs a node), B3_NGP (Gauss points)
// and B3_REAL (float or double), and B3_HG=1 for the hourglass quad4.  C
// entry points: they launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#if !defined(B3_NPE) || !defined(B3_NDIM) || !defined(B3_NGP) || \
    !defined(B3_REAL)
#error "build with -DB3_NPE=.. -DB3_NDIM=.. -DB3_NGP=.. -DB3_REAL=.."
#endif
#ifndef B3_HG
#define B3_HG 0
#endif

namespace {

using Real = B3_REAL;
constexpr int kNpe = B3_NPE;
constexpr int kDim = B3_NDIM;
constexpr int kGauss = B3_NGP;
constexpr int kSlots = kNpe * kDim;           // NS: an element's dofs
constexpr int kVoigt = kDim == 2 ? 3 : 6;
constexpr int kElementThreads = 128;
constexpr int kNodeThreads = 256;
constexpr int kBatch = 8;
static_assert(kDim == 2 || kDim == 3, "2D or 3D elements");
static_assert(!B3_HG || (kNpe == 4 && kDim == 2 && kGauss == 1),
              "the hourglass pass is the 1-point quad4's");

// B's nonzeros for component c: the k-th Voigt row s, ascending, and its
// derivative d (B[s, (i, c)] = dN_i/dx_d).  Voigt order 2D (xx, yy, xy),
// 3D (xx, yy, zz, xy, yz, zx), as elements/elasticity.py:_bsel:
//   2D  c = 0: (0, 0) (2, 1)          c = 1: (1, 1) (2, 0)
//   3D  c = 0: (0, 0) (3, 1) (5, 2)   c = 1: (1, 1) (3, 0) (4, 2)
//       c = 2: (2, 2) (4, 1) (5, 0)
constexpr int kTerms = kDim;

__device__ __forceinline__ constexpr int row_of(int c, int k) {
  if (k == 0) return c;
  if (kDim == 2) return 2;
  return c == 0 ? (k == 1 ? 3 : 5) : c == 1 ? (k == 1 ? 3 : 4) : (k == 1 ? 4 : 5);
}

__device__ __forceinline__ constexpr int der_of(int c, int k) {
  if (k == 0) return c;
  if (kDim == 2) return 1 - c;
  return c == 0 ? k : c == 1 ? (k == 1 ? 0 : 2) : (k == 1 ? 1 : 0);
}

// Rounding as the plain step's torch ops round: a product that a torch op
// writes out is rounded before it is summed (mul: never fused into an add),
// and an addcmul_ is one fused multiply-add (fused), as the CPU's is.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float fused(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fused(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

}  // namespace

// The element pass's launch parameters (dynamics/explicit_cuda.py:
// element_params), passed by value.
#if B3_HG
struct ElementParams {
  int64_t n_elem;
  Real dens;
  Real D[9];                 // plane stress, row-major; zeros are skipped
  Real thick;                // dvol = area * thick
  Real hg;                   // 0.25 hg_visc dens wave_speed
};
#else
struct ElementParams {
  int64_t n_elem;
  Real dens;
  Real D[kVoigt * kVoigt];   // row-major; its isotropic pattern is assumed
  Real N[kGauss * kNpe];     // N[g * NPE + i]: basis values at the points
};
#endif

// The node pass's (explicit_cuda.py:node_params).
struct NodeParams {
  int64_t n_node;
  Real dt, dtt, idtt, two_dt;  // dt, dt^2, 1/dt^2, 2 dt in the working type
};

namespace {

// sigma = D eps over D's isotropic pattern: the normal rows take the normal
// strains in order, a shear row its own strain; eps is tensorial (the
// shear strain 0.5 (du_a/dx_b + du_b/dx_a)), as apply_residual's _ssel.
__device__ __forceinline__ void stress(const Real (&gd)[kDim][kDim],
                                       const ElementParams& p,
                                       Real (&sig)[kVoigt]) {
  Real eps[kVoigt];
#pragma unroll
  for (int s = 0; s < kDim; ++s) eps[s] = gd[s][s];
  const Real h = Real(0.5);
  if constexpr (kDim == 2) {
    eps[2] = mul(h, gd[0][1]) + mul(h, gd[1][0]);
  } else {
    eps[3] = mul(h, gd[0][1]) + mul(h, gd[1][0]);
    eps[4] = mul(h, gd[1][2]) + mul(h, gd[2][1]);
    eps[5] = mul(h, gd[0][2]) + mul(h, gd[2][0]);
  }
#pragma unroll
  for (int s = 0; s < kDim; ++s) {
    Real acc = mul(p.D[s * kVoigt], eps[0]);
#pragma unroll
    for (int t = 1; t < kDim; ++t) acc = acc + mul(p.D[s * kVoigt + t], eps[t]);
    sig[s] = acc;
  }
#pragma unroll
  for (int s = kDim; s < kVoigt; ++s) sig[s] = mul(p.D[s * kVoigt + s], eps[s]);
}

constexpr int kPad = kSlots + 1;

// The block's elements' values, staged in shared memory (kPad values a
// thread), written out as one contiguous run of Fe.
__device__ __forceinline__ void write_staged(const Real* stage,
                                             Real* __restrict__ fe,
                                             int64_t first, int64_t n) {
  const int64_t left = n - first;
  const int count = (left < kElementThreads ? static_cast<int>(left)
                                            : kElementThreads) * kSlots;
  Real* dst = fe + first * kSlots;
  for (int k = threadIdx.x; k < count; k += kElementThreads)
    dst[k] = stage[(k / kSlots) * kPad + k % kSlots];
}

#if B3_HG

// sum_i a[i] * d[i], the nodes ascending, each product rounded.
__device__ __forceinline__ Real dot4(const Real (&a)[4], const Real (&d)[4]) {
  return ((mul(a[0], d[0]) + mul(a[1], d[1])) + mul(a[2], d[2])) +
         mul(a[3], d[3]);
}

__global__ void __launch_bounds__(kElementThreads)
element_pass_hourglass(const int32_t* __restrict__ conn,
                       const Real* __restrict__ geom,
                       const Real* __restrict__ u, const Real* __restrict__ v,
                       const Real* __restrict__ b, Real* __restrict__ fe,
                       const __grid_constant__ ElementParams p) {
  __shared__ Real stage[kElementThreads * kPad];
  const int64_t n = p.n_elem;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kElementThreads;
  const int64_t e = first + threadIdx.x;
  if (e < n) {
    Real ux[4], uy[4], vx[4], vy[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t node = __ldg(conn + i * n + e);
      ux[i] = __ldg(u + 2 * node);
      uy[i] = __ldg(u + 2 * node + 1);
      vx[i] = __ldg(v + 2 * node);
      vy[i] = __ldg(v + 2 * node + 1);
    }
    const Real a0 = __ldg(geom + e), a1 = __ldg(geom + n + e);
    const Real c0 = __ldg(geom + 2 * n + e), c1 = __ldg(geom + 3 * n + e);
    const Real area = __ldg(geom + 4 * n + e);
    const Real dx[4] = {a0, a1, -a0, -a1};
    const Real dy[4] = {c0, c1, -c0, -c1};
    const Real eps[3] = {dot4(ux, dx), dot4(uy, dy),
                         mul(Real(0.5), dot4(ux, dy) + dot4(uy, dx))};
    Real sig[3];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      Real acc = Real(0);
#pragma unroll
      for (int t = 0; t < 3; ++t)
        if (p.D[s * 3 + t] != Real(0)) acc = acc + mul(p.D[s * 3 + t], eps[t]);
      sig[s] = acc;
    }
    const Real dvol = mul(area, p.thick);
    const Real body = mul(mul(p.dens, dvol), Real(0.25));
    const Real fbx = mul(body, __ldg(b)), fby = mul(body, __ldg(b + 1));
    const Real hg = mul(p.hg, sqrt(fabs(area)));
    const Real h1 = mul(-(((vx[0] - vx[1]) + vx[2]) - vx[3]), hg);
    const Real h2 = mul(-(((vy[0] - vy[1]) + vy[2]) - vy[3]), hg);
    Real* out = stage + threadIdx.x * kPad;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Real fx = fbx - mul(dvol, mul(dx[i], sig[0]) + mul(dy[i], sig[2]));
      const Real fy = fby - mul(dvol, mul(dx[i], sig[2]) + mul(dy[i], sig[1]));
      out[2 * i] = fx + (i % 2 ? -h1 : h1);
      out[2 * i + 1] = fy + (i % 2 ? -h2 : h2);
    }
  }
  __syncthreads();
  write_staged(stage, fe, first, n);
}

#else

__global__ void __launch_bounds__(kElementThreads)
element_pass(const int32_t* __restrict__ conn, const Real* __restrict__ gradN,
             const Real* __restrict__ dvol, const Real* __restrict__ u,
             const Real* __restrict__ b, Real* __restrict__ fe,
             const __grid_constant__ ElementParams p) {
  __shared__ Real stage[kElementThreads * kPad];
  const int64_t n = p.n_elem;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kElementThreads;
  const int64_t e = first + threadIdx.x;
  if (e < n) {
    Real ue[kNpe][kDim];
#pragma unroll
    for (int i = 0; i < kNpe; ++i) {
      const int64_t node = __ldg(conn + i * n + e);
#pragma unroll
      for (int c = 0; c < kDim; ++c) ue[i][c] = __ldg(u + node * kDim + c);
    }
    Real f[kNpe][kDim];          // B^T sigma dvol, summed over g and s
    Real w[kNpe];                // sum_g N[g, i] dvol_g
#pragma unroll
    for (int i = 0; i < kNpe; ++i) {
      w[i] = Real(0);
#pragma unroll
      for (int c = 0; c < kDim; ++c) f[i][c] = Real(0);
    }
#pragma unroll
    for (int g = 0; g < kGauss; ++g) {
      const Real dv = __ldg(dvol + g * n + e);
      Real gn[kDim][kNpe];
#pragma unroll
      for (int d = 0; d < kDim; ++d)
#pragma unroll
        for (int i = 0; i < kNpe; ++i)
          gn[d][i] = __ldg(gradN + ((g * kDim + d) * kNpe + i) * n + e);
      Real gd[kDim][kDim];       // du_c/dx_d, summed over i ascending
#pragma unroll
      for (int c = 0; c < kDim; ++c)
#pragma unroll
        for (int d = 0; d < kDim; ++d) {
          Real acc = mul(ue[0][c], gn[d][0]);
#pragma unroll
          for (int i = 1; i < kNpe; ++i) acc = fused(ue[i][c], gn[d][i], acc);
          gd[c][d] = acc;
        }
      Real sig[kVoigt];
      stress(gd, p, sig);
#pragma unroll
      for (int i = 0; i < kNpe; ++i) {
        w[i] = w[i] + mul(p.N[g * kNpe + i], dv);
#pragma unroll
        for (int c = 0; c < kDim; ++c)
#pragma unroll
          for (int k = 0; k < kTerms; ++k)
            f[i][c] = fused(mul(dv, gn[der_of(c, k)][i]), sig[row_of(c, k)],
                          f[i][c]);
      }
    }
    Real* out = stage + threadIdx.x * kPad;
#pragma unroll
    for (int i = 0; i < kNpe; ++i)
#pragma unroll
      for (int c = 0; c < kDim; ++c)
        out[i * kDim + c] = mul(p.dens, mul(w[i], __ldg(b + c))) - f[i][c];
  }
  __syncthreads();
  write_staged(stage, fe, first, n);
}

#endif  // B3_HG

__global__ void __launch_bounds__(kNodeThreads)
node_pass(const int32_t* __restrict__ offsets,
          const int32_t* __restrict__ entries, const Real* __restrict__ fe,
          const Real* __restrict__ fext, const Real* __restrict__ mass,
          const uint8_t* __restrict__ upd, const Real* __restrict__ u,
          const Real* __restrict__ carry, Real* __restrict__ u_new,
          Real* __restrict__ carry_new, Real* __restrict__ velo,
          const __grid_constant__ NodeParams q) {
  const int64_t d =
      static_cast<int64_t>(blockIdx.x) * kNodeThreads + threadIdx.x;
  if (d >= q.n_node * kDim) return;
  const int64_t node = d / kDim;
  const Real* fc = fe + (d - node * kDim);
  const int32_t begin = __ldg(offsets + node);
  const int32_t end = __ldg(offsets + node + 1);
  Real acc = Real(0);
  for (int32_t k = begin; k < end; k += kBatch) {
    int32_t at[kBatch];
    Real v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (k + j < end) at[j] = __ldg(entries + k + j);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (k + j < end) v[j] = __ldg(fc + at[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (k + j < end) acc += v[j];
  }
  const Real m = __ldg(mass + d);
  Real rhs = acc + __ldg(fext + d);
#if B3_HG
  // velocity form: carry is w = v^{n-1/2}, carry_new w_new
  const Real w = __ldg(carry + d);
  const Real w_new = __ldg(upd + d) ? w + mul(q.dt, rhs / m) : Real(0);
  const Real next = __ldg(upd + d) ? __ldg(u + d) + mul(q.dt, w_new) : Real(0);
  u_new[d] = next;
  carry_new[d] = w_new;
  velo[d] = mul(w + w_new, Real(0.5));
#else
  // displacement form: carry is u_prev; carry_new is not written
  const Real up = __ldg(carry + d);
  rhs = rhs + mul(mul(q.idtt, m), mul(Real(2), __ldg(u + d)) - up);
  const Real next = __ldg(upd + d) ? mul(q.dtt, rhs) / m : Real(0);
  u_new[d] = next;
  velo[d] = (next - up) / q.two_dt;
#endif
}

bool grid_of(int64_t n, int threads, unsigned* grid) {
  const int64_t g = (n + threads - 1) / threads;
  if (n < 0 || g > 0x7fffffff) return false;
  *grid = static_cast<unsigned>(g);
  return true;
}

}  // namespace

extern "C" {

#if B3_HG
int explicit_step_element(const void* conn, const void* geom, const void* u,
                          const void* v, const void* b, void* fe,
                          ElementParams p, void* stream) {
  unsigned grid;
  if (!grid_of(p.n_elem, kElementThreads, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0)
    element_pass_hourglass<<<grid, kElementThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(conn), static_cast<const Real*>(geom),
        static_cast<const Real*>(u), static_cast<const Real*>(v),
        static_cast<const Real*>(b), static_cast<Real*>(fe), p);
  return static_cast<int>(cudaGetLastError());
}
#else
int explicit_step_element(const void* conn, const void* gradN,
                          const void* dvol, const void* u, const void* b,
                          void* fe, ElementParams p, void* stream) {
  unsigned grid;
  if (!grid_of(p.n_elem, kElementThreads, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0)
    element_pass<<<grid, kElementThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(conn), static_cast<const Real*>(gradN),
        static_cast<const Real*>(dvol), static_cast<const Real*>(u),
        static_cast<const Real*>(b), static_cast<Real*>(fe), p);
  return static_cast<int>(cudaGetLastError());
}
#endif

int explicit_step_node(const void* offsets, const void* entries,
                       const void* fe, const void* fext, const void* mass,
                       const void* upd, const void* u, const void* carry,
                       void* u_new, void* carry_new, void* velo, NodeParams q,
                       void* stream) {
  unsigned grid;
  if (!grid_of(q.n_node * kDim, kNodeThreads, &grid))
    return static_cast<int>(cudaErrorInvalidValue);
  if (grid > 0)
    node_pass<<<grid, kNodeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(entries), static_cast<const Real*>(fe),
        static_cast<const Real*>(fext), static_cast<const Real*>(mass),
        static_cast<const uint8_t*>(upd), static_cast<const Real*>(u),
        static_cast<const Real*>(carry), static_cast<Real*>(u_new),
        static_cast<Real*>(carry_new), static_cast<Real*>(velo), q);
  return static_cast<int>(cudaGetLastError());
}

const char* explicit_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
