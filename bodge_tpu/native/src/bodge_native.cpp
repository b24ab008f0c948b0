// bodge_tpu native host runtime.
//
// The device compute path is JAX/XLA; this library is the *host-side*
// native tier: fused assembly scatter, generic-skeleton mirror resolution,
// and the Hermiticity invariant check, operating directly on the ELL block
// arrays while they are host-resident (before the first device upload).
//
// Reference analogs: the assembly scatter implements the same symmetry
// autofill as bodge/hamiltonian.py:102-118 (hopping -> +v / -v*, pairing ->
// +v / v^dagger at the mirror block); the Hermiticity check is the
// reference's post-assembly gate (bodge/hamiltonian.py:120-122); the mirror
// resolution replaces the Python dict scan used for non-cubic skeletons.
//
// All entry points are extern "C" over raw pointers so the Python side can
// bind with ctypes (no pybind11 in this image). Complex data is interleaved
// (re, im) pairs, NumPy-compatible. Layouts:
//   data        [N, S, 4, 4] complex
//   cols        [N, S] int32, -1 = padding
//   onsite      [N, 2, 2] complex (or null)
//   hop/pair/pair_rev [S-1, N, 2, 2] complex (or null)

#include <atomic>
#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr int B = 4;        // block edge: Nambu (x) Spin
constexpr int BB = B * B;   // scalars per block

template <typename T>
using cplx = std::complex<T>;

// ---------------------------------------------------------------------------
// Fused assembly scatter: one pass over rows applying every symmetry write.
// ---------------------------------------------------------------------------
template <typename T>
void assemble_scatter(cplx<T>* data, const int32_t* cols, int64_t N, int32_t S,
                      const cplx<T>* onsite, const cplx<T>* pair_onsite,
                      const cplx<T>* hop, const cplx<T>* pair,
                      const cplx<T>* pair_rev, int reset) {
  const int64_t row_stride = static_cast<int64_t>(S) * BB;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < N; ++i) {
    cplx<T>* row = data + i * row_stride;
    if (reset) std::memset(row, 0, sizeof(cplx<T>) * row_stride);

    // Slot 0: diagonal block.
    cplx<T>* d0 = row;  // [4,4]
    if (onsite) {
      const cplx<T>* v = onsite + i * 4;  // [2,2]
      // H[0:2,0:2] = +v ; H[2:4,2:4] = -conj(v)
      for (int a = 0; a < 2; ++a)
        for (int b = 0; b < 2; ++b) {
          d0[a * B + b] = v[a * 2 + b];
          d0[(a + 2) * B + (b + 2)] = -std::conj(v[a * 2 + b]);
        }
    }
    if (pair_onsite) {
      const cplx<T>* v = pair_onsite + i * 4;
      // H[0:2,2:4] = +v ; H[2:4,0:2] = v^dagger
      for (int a = 0; a < 2; ++a)
        for (int b = 0; b < 2; ++b) {
          d0[a * B + (b + 2)] = v[a * 2 + b];
          d0[(a + 2) * B + b] = std::conj(v[b * 2 + a]);
        }
    }

    // Off-diagonal slots.
    for (int32_t s = 1; s < S; ++s) {
      if (cols[i * S + s] < 0) continue;
      cplx<T>* ds = row + static_cast<int64_t>(s) * BB;
      const int64_t k = static_cast<int64_t>(s - 1) * N + i;  // [S-1, N] layout
      if (hop) {
        const cplx<T>* v = hop + k * 4;
        for (int a = 0; a < 2; ++a)
          for (int b = 0; b < 2; ++b) {
            ds[a * B + b] = v[a * 2 + b];
            ds[(a + 2) * B + (b + 2)] = -std::conj(v[a * 2 + b]);
          }
      }
      if (pair) {
        const cplx<T>* v = pair + k * 4;
        const cplx<T>* vr = pair_rev + k * 4;
        for (int a = 0; a < 2; ++a)
          for (int b = 0; b < 2; ++b) {
            ds[a * B + (b + 2)] = v[a * 2 + b];
            // H[2:4,0:2] at slot s of row i couples back to the *reverse*
            // bond: conj-transpose of pairing(cj, ci).
            ds[(a + 2) * B + b] = std::conj(vr[b * 2 + a]);
          }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Hermiticity check: max |H - H^dagger| over all structural blocks.
// ---------------------------------------------------------------------------
template <typename T>
double herm_error(const cplx<T>* data, const int32_t* cols,
                  const int32_t* trans, int64_t N, int32_t S, int trans_2d) {
  const int64_t row_stride = static_cast<int64_t>(S) * BB;
  double gmax = 0.0;
#ifdef _OPENMP
#pragma omp parallel reduction(max : gmax)
#endif
  {
#ifdef _OPENMP
#pragma omp for schedule(static)
#endif
    for (int64_t i = 0; i < N; ++i) {
      double lmax = 0.0;
      for (int32_t s = 0; s < S; ++s) {
        const int32_t j = cols[i * S + s];
        if (j < 0) continue;
        const int32_t t = trans_2d ? trans[i * S + s] : trans[s];
        const cplx<T>* a = data + i * row_stride + static_cast<int64_t>(s) * BB;
        const cplx<T>* m = data + static_cast<int64_t>(j) * row_stride +
                           static_cast<int64_t>(t) * BB;
        for (int p = 0; p < B; ++p)
          for (int q = 0; q < B; ++q) {
            const cplx<T> diff = a[p * B + q] - std::conj(m[q * B + p]);
            const double v = std::abs(std::complex<double>(diff.real(), diff.imag()));
            if (v > lmax) lmax = v;
          }
      }
      if (lmax > gmax) gmax = lmax;
    }
  }
  return gmax;
}

}  // namespace

extern "C" {

void bodge_assemble_c64(void* data, const int32_t* cols, int64_t N, int32_t S,
                        const void* onsite, const void* pair_onsite,
                        const void* hop, const void* pair, const void* pair_rev,
                        int reset) {
  assemble_scatter<float>(
      static_cast<cplx<float>*>(data), cols, N, S,
      static_cast<const cplx<float>*>(onsite),
      static_cast<const cplx<float>*>(pair_onsite),
      static_cast<const cplx<float>*>(hop),
      static_cast<const cplx<float>*>(pair),
      static_cast<const cplx<float>*>(pair_rev), reset);
}

void bodge_assemble_c128(void* data, const int32_t* cols, int64_t N, int32_t S,
                         const void* onsite, const void* pair_onsite,
                         const void* hop, const void* pair, const void* pair_rev,
                         int reset) {
  assemble_scatter<double>(
      static_cast<cplx<double>*>(data), cols, N, S,
      static_cast<const cplx<double>*>(onsite),
      static_cast<const cplx<double>*>(pair_onsite),
      static_cast<const cplx<double>*>(hop),
      static_cast<const cplx<double>*>(pair),
      static_cast<const cplx<double>*>(pair_rev), reset);
}

double bodge_herm_error_c64(const void* data, const int32_t* cols,
                            const int32_t* trans, int64_t N, int32_t S,
                            int trans_2d) {
  return herm_error<float>(static_cast<const cplx<float>*>(data), cols, trans,
                           N, S, trans_2d);
}

double bodge_herm_error_c128(const void* data, const int32_t* cols,
                             const int32_t* trans, int64_t N, int32_t S,
                             int trans_2d) {
  return herm_error<double>(static_cast<const cplx<double>*>(data), cols,
                            trans, N, S, trans_2d);
}

// Resolve Hermitian-mirror slots for a generic (non-stencil) skeleton:
// trans[i, s] = t such that cols[j, t] == i for j = cols[i, s].
// Returns 0 on success, 1 if any structural block lacks its mirror.
int bodge_mirror_slots(const int32_t* cols, int64_t N, int32_t S,
                       int32_t* trans_out) {
  std::atomic<int> bad{0};
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < N; ++i) {
    for (int32_t s = 0; s < S; ++s) {
      const int32_t j = cols[i * S + s];
      trans_out[i * S + s] = 0;
      if (j < 0) continue;
      int32_t found = -1;
      const int32_t* row_j = cols + static_cast<int64_t>(j) * S;
      for (int32_t t = 0; t < S; ++t) {
        if (row_j[t] == static_cast<int32_t>(i)) {
          found = t;
          break;
        }
      }
      if (found < 0) {
        bad.store(1, std::memory_order_relaxed);
      } else {
        trans_out[i * S + s] = found;
      }
    }
  }
  return bad.load();
}

}  // extern "C"
