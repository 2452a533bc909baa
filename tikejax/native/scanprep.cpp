// Host-side scan-position preprocessing for tikejax.
//
// Native counterpart of the reference's C++ runtime layer ([R]
// src/cuda/ptychofft.cu constructor-side setup + SWIG binding, SURVEY.md
// SS2/C1+C4): the compute path is JAX/XLA, but the host runtime
// work -- validating and conditioning hundreds of thousands of scan
// positions per projection before upload -- is native C++ exposed over a
// plain C ABI (ctypes; no SWIG/pybind dependency).
//
// Functions:
//   scanprep_validate: floor float (y, x) to int32, bounds-check against
//     the object/probe geometry. Returns the number of out-of-bounds
//     positions (0 == all valid).
//   scanprep_overlap_counts: per-pixel patch coverage counts (the
//     illumination map denominator) computed in one pass -- O(nscan)
//     using a 2-D difference-array instead of O(nscan * nprb^2)
//     scatter.
//
// Build: cc -O3 -shared -fPIC scanprep.cpp -o libscanprep.so (driven by
// tikejax/native/build.py at import time; pure-python fallbacks exist).

#include <cstdint>
#include <cmath>
#include <vector>

extern "C" {

// Floor float coords to int32; count out-of-bounds positions.
// scan: (n, 2) float32 (y, x); out: (n, 2) int32.
int64_t scanprep_validate(const float* scan, int64_t n, int32_t nz,
                          int32_t nx, int32_t nprb, int32_t* out) {
    int64_t bad = 0;
    const int32_t ymax = nz - nprb;
    const int32_t xmax = nx - nprb;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t y = (int32_t)std::floor(scan[2 * i]);
        const int32_t x = (int32_t)std::floor(scan[2 * i + 1]);
        out[2 * i] = y;
        out[2 * i + 1] = x;
        if (y < 0 || x < 0 || y > ymax || x > xmax) ++bad;
    }
    return bad;
}

// Per-pixel coverage counts via 2-D difference array: O(n + nz*nx).
// counts: (nz, nx) float32, pre-zeroed by the caller.
void scanprep_overlap_counts(const int32_t* scan, int64_t n, int32_t nz,
                             int32_t nx, int32_t nprb, float* counts) {
    // difference array with one guard row/col
    std::vector<float> diff((size_t)(nz + 1) * (nx + 1), 0.0f);
    const int64_t w = nx + 1;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t y = scan[2 * i];
        const int32_t x = scan[2 * i + 1];
        if (y < 0 || x < 0 || y + nprb > nz || x + nprb > nx) continue;
        diff[(size_t)(y * w + x)] += 1.0f;
        diff[(size_t)(y * w + x + nprb)] -= 1.0f;
        diff[(size_t)((y + nprb) * w + x)] -= 1.0f;
        diff[(size_t)((y + nprb) * w + x + nprb)] += 1.0f;
    }
    // 2-D prefix sum into counts
    for (int32_t r = 0; r < nz; ++r) {
        float row_acc = 0.0f;
        for (int32_t c = 0; c < nx; ++c) {
            row_acc += diff[(size_t)(r * w + c)];
            const float above = r > 0 ? counts[(size_t)((r - 1) * nx + c)]
                                      : 0.0f;
            counts[(size_t)(r * nx + c)] = row_acc + above;
        }
    }
}

}  // extern "C"
