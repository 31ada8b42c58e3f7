// Parity harness: runs the default bunny-in-sphere scene on the C++
// reference and dumps raw particle positions per frame (binary f32 xyz) for
// statistical comparison with the JAX engine's output.
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>

#include "fluidsimulation.h"
#include "trianglemesh.h"

int main(int argc, char **argv) {
    int numFrames = argc > 1 ? atoi(argv[1]) : 20;
    int res = argc > 2 ? atoi(argv[2]) : 32;
    const char *outdir = argc > 3 ? argv[3] : ".";
    float viscosity = argc > 4 ? (float)atof(argv[4]) : 5.0f;

    FluidSimulation fluidsim;
    fluidsim.initialize(res, res, res, 1.0f / res);

    TriangleMesh boundaryMesh, liquidMesh;
    boundaryMesh.loadPLY("/root/reference/sample_meshes/sphere_large.ply");
    fluidsim.addBoundary(boundaryMesh, true);
    liquidMesh.loadPLY("/root/reference/sample_meshes/stanford_bunny.ply");
    fluidsim.addLiquid(liquidMesh);
    fluidsim.setViscosity(viscosity);
    fluidsim.setGravity(0.0f, -9.81f, 0.0f);

    for (int frame = 0; frame < numFrames; frame++) {
        char path[512];
        snprintf(path, sizeof(path), "%s/ref_%04d.bin", outdir, frame);
        FILE *f = fopen(path, "wb");
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
