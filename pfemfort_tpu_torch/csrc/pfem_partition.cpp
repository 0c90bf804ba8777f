// Copied from pfemfort_tpu/native/src/pfem_partition.cpp (linked with csrc/host_native.cpp by cuda_build.py:HostProgram).
// CLI: mesh partitioner + VTK partition visualization.
// Usage: pfem_partition ndim npe method nparts nodesfile elemsfile [out.vtk]
//   method: 0 = RCB on element centroids, 1 = greedy dual-graph k-way
// Mirrors the reference's serial METIS partitioner CLI
// (the reference's src/meshpartitioncpp.cpp: `ndim eType metisType nparts
// nodesfile elemsfile` -> colored partition file), with METIS replaced by
// the native RCB / greedy k-way and edge-cut reporting.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
void pfem_rcb_partition(const double*, int64_t, int, int, int32_t*);
void pfem_greedy_partition(const int32_t*, int64_t, int, int64_t, int, int,
                           int32_t*);
int64_t pfem_edge_cut(const int32_t*, int64_t, int, int64_t, int,
                      const int32_t*);
int pfem_write_vtk(const char*, int64_t, const double*, int64_t, int,
                   const int32_t*, int, const int32_t*, int, const double*);
}

static int vtk_type_for(int ndim, int npe) {
  if (ndim == 2) return npe == 3 ? 5 : (npe == 6 ? 22 : 9);
  return npe == 4 ? 10 : (npe == 6 ? 13 : 12);
}

static int ncommon_for(int ndim, int npe) {
  // same table as the reference partitioners (meshpartitionfortparmetis.cpp:
  // 139-158): tria/quad 2, tet 3, hex 4
  if (ndim == 2) return 2;
  return npe == 4 ? 3 : (npe == 8 ? 4 : 3);
}

int main(int argc, char** argv) {
  if (argc < 7) {
    fprintf(stderr,
            "usage: %s ndim npe method(0=rcb,1=greedy) nparts nodesfile "
            "elemsfile [out.vtk]\n",
            argv[0]);
    return 2;
  }
  int ndim = atoi(argv[1]), npe = atoi(argv[2]), method = atoi(argv[3]),
      nparts = atoi(argv[4]);

  // read nodes: id x y [z]
  FILE* f = fopen(argv[5], "r");
  if (!f) { fprintf(stderr, "cannot open %s\n", argv[5]); return 1; }
  std::vector<double> coords;  // x,y,z padded
  {
    long long id;
    double x, y, z;
    while (true) {
      int got = ndim == 2 ? fscanf(f, "%lld %lf %lf", &id, &x, &y)
                          : fscanf(f, "%lld %lf %lf %lf", &id, &x, &y, &z);
      if (got != (ndim == 2 ? 3 : 4)) break;
      coords.push_back(x);
      coords.push_back(y);
      coords.push_back(ndim == 2 ? 0.0 : z);
    }
  }
  fclose(f);
  int64_t n_node = (int64_t)coords.size() / 3;

  f = fopen(argv[6], "r");
  if (!f) { fprintf(stderr, "cannot open %s\n", argv[6]); return 1; }
  std::vector<int32_t> conn;
  {
    long long id, n;
    while (fscanf(f, "%lld", &id) == 1) {
      for (int p = 0; p < npe; ++p) {
        if (fscanf(f, "%lld", &n) != 1) { fprintf(stderr, "bad elems\n"); return 1; }
        conn.push_back((int32_t)(n - 1));
      }
    }
  }
  fclose(f);
  int64_t n_elem = (int64_t)conn.size() / npe;
  printf(" nNode %lld  nElem %lld  npe %d\n", (long long)n_node,
         (long long)n_elem, npe);

  std::vector<int32_t> part(n_elem);
  if (method == 0) {
    std::vector<double> cent(n_elem * ndim);
    for (int64_t e = 0; e < n_elem; ++e)
      for (int d = 0; d < ndim; ++d) {
        double s = 0;
        for (int p = 0; p < npe; ++p) s += coords[conn[e * npe + p] * 3 + d];
        cent[e * ndim + d] = s / npe;
      }
    pfem_rcb_partition(cent.data(), n_elem, ndim, nparts, part.data());
  } else {
    pfem_greedy_partition(conn.data(), n_elem, npe, n_node,
                          ncommon_for(ndim, npe), nparts, part.data());
  }

  std::vector<int64_t> sizes(nparts, 0);
  for (int64_t e = 0; e < n_elem; ++e) sizes[part[e]]++;
  printf(" partition sizes:");
  for (int p = 0; p < nparts; ++p) printf(" %lld", (long long)sizes[p]);
  printf("\n edge-cut: %lld\n",
         (long long)pfem_edge_cut(conn.data(), n_elem, npe, n_node,
                                  ncommon_for(ndim, npe), part.data()));

  if (argc > 7) {
    if (pfem_write_vtk(argv[7], n_node, coords.data(), n_elem, npe,
                       conn.data(), vtk_type_for(ndim, npe), part.data(), 0,
                       nullptr)) {
      fprintf(stderr, "failed to write %s\n", argv[7]);
      return 1;
    }
    printf(" wrote %s\n", argv[7]);
  }
  return 0;
}
