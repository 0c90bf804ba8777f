// Copied from pfemfort_tpu/native/src/pfem_gentet.cpp (linked with csrc/host_native.cpp by cuda_build.py:HostProgram).
// CLI: structured box -> 6-tet mesh generator.
// Usage: pfem_gentet x0 x1 nEx y0 y1 nEy z0 z1 nEz [prefix]
// Same argument convention as the reference generator
// (the reference's src/genTetranovtk.cpp:70-85), writing the
// <prefix>-{nodes,elems,DirichBC}.dat triplet with u = x^2+y^2+z^2 boundary
// values (the correct VTK-twin behavior; the novtk twin's BC values read
// uninitialized memory — SURVEY §2.3).

#include <cstdio>
#include <cstdlib>

extern "C" int pfem_gen_tet_mesh(double, double, long long, double, double,
                                 long long, double, double, long long,
                                 const char*);

int main(int argc, char** argv) {
  if (argc < 10) {
    fprintf(stderr,
            "usage: %s x0 x1 nEx y0 y1 nEy z0 z1 nEz [prefix=mesh]\n",
            argv[0]);
    return 2;
  }
  const char* prefix = argc > 10 ? argv[10] : "mesh";
  int rc = pfem_gen_tet_mesh(atof(argv[1]), atof(argv[2]), atoll(argv[3]),
                             atof(argv[4]), atof(argv[5]), atoll(argv[6]),
                             atof(argv[7]), atof(argv[8]), atoll(argv[9]),
                             prefix);
  if (rc) {
    fprintf(stderr, "failed to write mesh files\n");
    return 1;
  }
  printf("wrote %s-nodes.dat %s-elems.dat %s-DirichBC.dat\n", prefix, prefix,
         prefix);
  return 0;
}
