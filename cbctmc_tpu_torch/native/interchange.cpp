// Native interchange codecs of cbctmc_tpu_torch (host C++, no device code).
//
// The port's own copy of the JAX package's native/interchange.cpp, the
// function bodies unchanged. Two hot host-side loops in C++:
//  - the Cython + multiprocessing penEasy voxel-string compiler
//    (reference: cbctmc/mc/voxel_data.pyx — minutes for 512^3 scenes), and
//  - the ASCII projection parser for legacy MC-GPU output files
//    (reference: cbctmc/mc/projection.py:37-51 via np.loadtxt + mp.Pool).
//
// Exposed as a plain C ABI consumed through ctypes
// (cbctmc_tpu_torch/native/__init__.py, which builds it with g++ at first
// use); no pybind11 dependency.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>

extern "C" {

// Render "<material> <density>\n" lines for n voxels into out.
// Returns the number of bytes written (excluding the NUL terminator).
// out must have room for at least n * 16 bytes.
int64_t render_vox_lines(
    const uint8_t* materials,
    const float* densities,
    int64_t n,
    char* out)
{
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        // material id (1..255)
        unsigned m = materials[i];
        if (m >= 100) { *p++ = '0' + m / 100; m %= 100; *p++ = '0' + m / 10; *p++ = '0' + m % 10; }
        else if (m >= 10) { *p++ = '0' + m / 10; *p++ = '0' + m % 10; }
        else { *p++ = '0' + m; }
        *p++ = ' ';
        // density with 6 decimals (matches the reference's %.6f rendering)
        double d = densities[i];
        if (d < 0) { *p++ = '-'; d = -d; }
        uint64_t scaled = (uint64_t)(d * 1e6 + 0.5);
        uint64_t ip = scaled / 1000000, fp = scaled % 1000000;
        char buf[24];
        int k = 0;
        if (ip == 0) buf[k++] = '0';
        while (ip) { buf[k++] = '0' + (char)(ip % 10); ip /= 10; }
        while (k) *p++ = buf[--k];
        *p++ = '.';
        for (int digit = 5; digit >= 0; --digit) {
            uint64_t pow10 = 1;
            for (int q = 0; q < digit; ++q) pow10 *= 10;
            *p++ = '0' + (char)((fp / pow10) % 10);
        }
        *p++ = '\n';
    }
    *p = '\0';
    return (int64_t)(p - out);
}

// Parse whitespace-separated ASCII floats into out (up to max_count).
// Handles the MC-GPU projection report format: '#' comment lines, blank
// separator lines, 4 columns per pixel. Returns the number parsed.
int64_t parse_ascii_floats(
    const char* text,
    int64_t text_len,
    double* out,
    int64_t max_count)
{
    const char* p = text;
    const char* end = text + text_len;
    int64_t count = 0;
    while (p < end && count < max_count) {
        // skip whitespace
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
            ++p;
        if (p >= end) break;
        if (*p == '#') {  // comment line
            while (p < end && *p != '\n') ++p;
            continue;
        }
        char* next = nullptr;
        double value = strtod(p, &next);
        if (next == p) { ++p; continue; }  // unparseable byte: skip
        out[count++] = value;
        p = next;
    }
    return count;
}

// Fixed-point deterministic detector accumulation (the reference engine
// tallies energy as u64 fixed point with SCALE_eV=100 so multi-order
// parallel sums are exactly reproducible; MC-GPU_kernel_v1.3.cu:455-463).
// Sums float energies into an int64 image with the given scale.
void accumulate_fixed_point(
    const float* energies,
    const int64_t* pixel_indices,
    int64_t n,
    int64_t n_pixels,
    double scale,
    int64_t* image)
{
    for (int64_t i = 0; i < n; ++i) {
        int64_t idx = pixel_indices[i];
        if (idx < 0 || idx >= n_pixels) continue;
        image[idx] += (int64_t)(energies[i] * scale + 0.5);
    }
}

}  // extern "C"
