// Host-side native runtime for rsparse_tpu.
//
// The reference's native substrate is zero-copy CSR/CSC views plus Rcpp glue
// (reference inst/include/mapped_csr.hpp:9-36, mapped_csc.hpp:9-29,
// src/utils.cpp:58-78).  This package's equivalent host duties are:
//   1. building padded nnz-bucketed (B, L) blocks that feed the device
//      (the layout transformation behind sparse/device.py::bucket_rows);
//   2. parsing interaction logs (user,item,rating text) into COO arrays at
//      memory bandwidth;
//   3. CSR transposition for the item-major orientation.
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in the
// image).  All functions are thread-parallel with OpenMP.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// 1. Padded bucket fill: for a list of row ids sharing one padded length L,
//    write col_idx (B, L), values (B, L) float32, nnz (B,), row_ids (B,).
//    Padding rows get row_id = n_rows_total (the dummy scatter slot).
// ---------------------------------------------------------------------------
void fill_bucket_f32(const int64_t* indptr, const int32_t* indices,
                     const double* data, const int64_t* rows, int64_t n_rows,
                     int64_t B, int64_t L, int64_t n_rows_total,
                     int32_t* col_idx, float* values, int32_t* nnz,
                     int32_t* row_ids) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t b = 0; b < B; b++) {
    int32_t* ci = col_idx + b * L;
    float* vv = values + b * L;
    if (b >= n_rows) {
      row_ids[b] = (int32_t)n_rows_total;
      nnz[b] = 0;
      std::memset(ci, 0, sizeof(int32_t) * L);
      std::memset(vv, 0, sizeof(float) * L);
      continue;
    }
    const int64_t r = rows[b];
    const int64_t p1 = indptr[r], p2 = indptr[r + 1];
    const int64_t m = p2 - p1;
    row_ids[b] = (int32_t)r;
    nnz[b] = (int32_t)m;
    for (int64_t k = 0; k < m; k++) {
      ci[k] = indices[p1 + k];
      vv[k] = (float)data[p1 + k];
    }
    std::memset(ci + m, 0, sizeof(int32_t) * (L - m));
    std::memset(vv + m, 0, sizeof(float) * (L - m));
  }
}

void fill_bucket_f64(const int64_t* indptr, const int32_t* indices,
                     const double* data, const int64_t* rows, int64_t n_rows,
                     int64_t B, int64_t L, int64_t n_rows_total,
                     int32_t* col_idx, double* values, int32_t* nnz,
                     int32_t* row_ids) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t b = 0; b < B; b++) {
    int32_t* ci = col_idx + b * L;
    double* vv = values + b * L;
    if (b >= n_rows) {
      row_ids[b] = (int32_t)n_rows_total;
      nnz[b] = 0;
      std::memset(ci, 0, sizeof(int32_t) * L);
      std::memset(vv, 0, sizeof(double) * L);
      continue;
    }
    const int64_t r = rows[b];
    const int64_t p1 = indptr[r], p2 = indptr[r + 1];
    const int64_t m = p2 - p1;
    row_ids[b] = (int32_t)r;
    nnz[b] = (int32_t)m;
    for (int64_t k = 0; k < m; k++) {
      ci[k] = indices[p1 + k];
      vv[k] = data[p1 + k];
    }
    std::memset(ci + m, 0, sizeof(int32_t) * (L - m));
    std::memset(vv + m, 0, sizeof(double) * (L - m));
  }
}

// ---------------------------------------------------------------------------
// 2. Interaction-log parser: "user<sep>item<sep>rating\n" lines (ratings
//    optional -> 1.0).  Two-phase OpenMP: chunk the buffer at line breaks,
//    parse each chunk independently, then compact.
//    Returns number of parsed triplets, or -1 on overflow of out_cap.
// ---------------------------------------------------------------------------
static inline const char* parse_long(const char* p, const char* end,
                                     long* out) {
  long v = 0;
  bool neg = false, any = false;
  if (p < end && (*p == '-')) { neg = true; p++; }
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    p++;
    any = true;
  }
  *out = neg ? -v : v;
  return any ? p : nullptr;
}

static inline const char* parse_double(const char* p, const char* end,
                                       double* out) {
  char tmp[64];
  int n = 0;
  while (p < end && n < 63 &&
         ((*p >= '0' && *p <= '9') || *p == '.' || *p == '-' || *p == '+' ||
          *p == 'e' || *p == 'E')) {
    tmp[n++] = *p++;
  }
  if (n == 0) return nullptr;
  tmp[n] = 0;
  *out = std::atof(tmp);
  return p;
}

int64_t parse_interactions(const char* buf, int64_t len, char sep,
                           int skip_header, int32_t* users, int32_t* items,
                           float* ratings, int64_t out_cap) {
  int n_threads = 1;
#ifdef _OPENMP
  n_threads = omp_get_max_threads();
#endif
  std::vector<int64_t> chunk_begin(n_threads + 1, len);
  chunk_begin[0] = 0;
  for (int t = 1; t < n_threads; t++) {
    int64_t pos = len * t / n_threads;
    while (pos < len && buf[pos] != '\n') pos++;
    chunk_begin[t] = pos < len ? pos + 1 : len;
  }
  chunk_begin[n_threads] = len;

  std::vector<std::vector<int32_t>> lu(n_threads), li(n_threads);
  std::vector<std::vector<float>> lr(n_threads);

#ifdef _OPENMP
#pragma omp parallel num_threads(n_threads)
#endif
  {
#ifdef _OPENMP
    const int t = omp_get_thread_num();
#else
    const int t = 0;
#endif
    const char* p = buf + chunk_begin[t];
    const char* end = buf + chunk_begin[t + 1];
    bool first_line = (t == 0);
    while (p < end) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      const char* line_end = nl ? nl : end;
      if (first_line && skip_header) {
        first_line = false;
        p = line_end + 1;
        continue;
      }
      first_line = false;
      long u, i;
      double r = 1.0;
      const char* q = parse_long(p, line_end, &u);
      if (q && q < line_end && (*q == sep)) {
        q = parse_long(q + 1, line_end, &i);
        if (q) {
          if (q < line_end && *q == sep) {
            parse_double(q + 1, line_end, &r);
          }
          lu[t].push_back((int32_t)u);
          li[t].push_back((int32_t)i);
          lr[t].push_back((float)r);
        }
      }
      p = line_end + 1;
    }
  }

  int64_t total = 0;
  for (int t = 0; t < n_threads; t++) total += (int64_t)lu[t].size();
  if (total > out_cap) return -1;
  int64_t off = 0;
  for (int t = 0; t < n_threads; t++) {
    std::memcpy(users + off, lu[t].data(), lu[t].size() * sizeof(int32_t));
    std::memcpy(items + off, li[t].data(), li[t].size() * sizeof(int32_t));
    std::memcpy(ratings + off, lr[t].data(), lr[t].size() * sizeof(float));
    off += (int64_t)lu[t].size();
  }
  return total;
}

// ---------------------------------------------------------------------------
// 3. CSR transpose (counting sort over columns) — the host analog of the
//    reference's t_shallow CSC<->CSR flip (R/model_WRMF.R:189).
// ---------------------------------------------------------------------------
void csr_transpose(const int64_t* indptr, const int32_t* indices,
                   const double* data, int64_t n_rows, int64_t n_cols,
                   int64_t nnz, int64_t* t_indptr, int32_t* t_indices,
                   double* t_data) {
  std::vector<int64_t> counts(n_cols + 1, 0);
  for (int64_t k = 0; k < nnz; k++) counts[indices[k] + 1]++;
  for (int64_t c = 0; c < n_cols; c++) counts[c + 1] += counts[c];
  std::memcpy(t_indptr, counts.data(), (n_cols + 1) * sizeof(int64_t));
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t r = 0; r < n_rows; r++) {
    for (int64_t k = indptr[r]; k < indptr[r + 1]; k++) {
      const int64_t c = indices[k];
      const int64_t dst = cursor[c]++;
      t_indices[dst] = (int32_t)r;
      t_data[dst] = data[k];
    }
  }
}

int omp_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
