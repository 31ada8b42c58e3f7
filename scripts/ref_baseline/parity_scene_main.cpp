// Generalized parity harness: runs an arbitrary mesh-defined scene on the
// C++ reference and dumps raw particle positions per frame (binary f32 xyz)
// for statistical comparison with the JAX engine's output.
//
// Usage: ref_parity_scene <frames> <res> <outdir> <viscosity>
//            <boundary.ply> <invert:0|1> <liquid.ply> [seed]
//
// The optional seed perturbs the reference's own particle seeding
// (fluidsimulation.cpp:80-82 uses rand() jitter) so an ensemble of
// reference runs bounds the solver's chaotic divergence envelope.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "fluidsimulation.h"
#include "trianglemesh.h"

int main(int argc, char **argv) {
    int numFrames = argc > 1 ? atoi(argv[1]) : 20;
    int res = argc > 2 ? atoi(argv[2]) : 64;
    const char *outdir = argc > 3 ? argv[3] : ".";
    float viscosity = argc > 4 ? (float)atof(argv[4]) : 5.0f;
    const char *boundaryPath =
        argc > 5 ? argv[5] : "/root/reference/sample_meshes/sphere_large.ply";
    int invert = argc > 6 ? atoi(argv[6]) : 1;
    const char *liquidPath =
        argc > 7 ? argv[7] : "/root/reference/sample_meshes/stanford_bunny.ply";
    if (argc > 8) srand((unsigned)atoi(argv[8]));

    FluidSimulation fluidsim;
    fluidsim.initialize(res, res, res, 1.0f / res);

    TriangleMesh boundaryMesh, liquidMesh;
    boundaryMesh.loadPLY(boundaryPath);
    fluidsim.addBoundary(boundaryMesh, invert != 0);
    liquidMesh.loadPLY(liquidPath);
    fluidsim.addLiquid(liquidMesh);
    fluidsim.setViscosity(viscosity);
    fluidsim.setGravity(0.0f, -9.81f, 0.0f);

    for (int frame = 0; frame < numFrames; frame++) {
        char path[512];
        snprintf(path, sizeof(path), "%s/ref_%04d.bin", outdir, frame);
        FILE *f = fopen(path, "wb");
        if (!f) { fprintf(stderr, "cannot open %s\n", path); return 1; }
        int n = (int)fluidsim.particles.size();
        fwrite(&n, sizeof(int), 1, f);
        for (int i = 0; i < n; i++) {
            vmath::vec3 p = fluidsim.particles[i].position;
            fwrite(&p.x, sizeof(float), 3, f);
        }
        fclose(f);
        fluidsim.advance(0.01f);
    }
    return 0;
}
