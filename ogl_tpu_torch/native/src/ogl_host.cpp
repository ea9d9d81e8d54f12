// Native host-side runtime for ogl_tpu.
//
// The reference implements its host conversion layer in C++
// (HostMatrix/HostMatrixFreeFunctions.C) and delegates factorisations to
// Ginkgo's native kernels; this library is the equivalent for the TPU
// framework's host side: one-time setup paths that are latency-sensitive
// on production meshes (many millions of cells) — LDU->row-major sparsity
// construction, incomplete factorisations, and AMG aggregation.  The
// device hot path stays JAX/Pallas; Python falls back to NumPy
// implementations when this library is unavailable.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// LDU -> row-major sorted local sparsity (semantics of
// ogl_tpu.core.ldu.init_local_sparsity; cf. reference
// HostMatrixFreeFunctions.C:105-201).  Arrays sized nnz = 2*nf + n.
// permute indexes the source layout [upper | (lower) | diag].
void ogl_init_local_sparsity(int64_t n, int64_t nf, int symmetric,
                             const int64_t* lower_addr,
                             const int64_t* upper_addr, int32_t* rows,
                             int32_t* cols, int32_t* permute) {
  const int64_t nnz = 2 * nf + n;
  const int64_t after_nbrs = symmetric ? nf : 2 * nf;

  // counting sort by row
  std::vector<int64_t> count(n + 1, 0);
  for (int64_t f = 0; f < nf; ++f) {
    ++count[lower_addr[f] + 1];  // upper entry in row lower_addr[f]
    ++count[upper_addr[f] + 1];  // lower entry in row upper_addr[f]
  }
  for (int64_t r = 0; r < n; ++r) ++count[r + 1];  // diagonal
  for (int64_t r = 0; r < n; ++r) count[r + 1] += count[r];

  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  // place entries unsorted-within-row first
  for (int64_t f = 0; f < nf; ++f) {
    int64_t p = cursor[lower_addr[f]]++;
    rows[p] = static_cast<int32_t>(lower_addr[f]);
    cols[p] = static_cast<int32_t>(upper_addr[f]);
    permute[p] = static_cast<int32_t>(f);
    p = cursor[upper_addr[f]]++;
    rows[p] = static_cast<int32_t>(upper_addr[f]);
    cols[p] = static_cast<int32_t>(lower_addr[f]);
    permute[p] = static_cast<int32_t>(symmetric ? f : nf + f);
  }
  for (int64_t r = 0; r < n; ++r) {
    int64_t p = cursor[r]++;
    rows[p] = static_cast<int32_t>(r);
    cols[p] = static_cast<int32_t>(r);
    permute[p] = static_cast<int32_t>(after_nbrs + r);
  }
  // sort within each row by column (rows are short: insertion sort)
  for (int64_t r = 0; r < n; ++r) {
    const int64_t s = count[r], e = count[r + 1];
    for (int64_t i = s + 1; i < e; ++i) {
      int32_t c = cols[i], pm = permute[i];
      int64_t j = i - 1;
      while (j >= s && cols[j] > c) {
        cols[j + 1] = cols[j];
        permute[j + 1] = permute[j];
        --j;
      }
      cols[j + 1] = c;
      permute[j + 1] = pm;
    }
  }
  (void)nnz;
}

// ILU(0), IKJ order, on CSR with row-major sorted columns
// (cf. Ginkgo factorization::Ilu used at reference Preconditioner.H:106).
// vals is overwritten with the combined L\U factors (unit-lower implicit).
// Returns 0 on success, -1 on zero pivot.
int ogl_ilu0(int64_t n, const int64_t* indptr, const int32_t* cols,
             double* vals) {
  // position of the diagonal in each row
  std::vector<int64_t> diag_pos(n, -1);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (cols[p] == i) diag_pos[i] = p;

  std::vector<int64_t> colmap(n, -1);
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) colmap[cols[p]] = p;
    for (int64_t kk = indptr[i]; kk < indptr[i + 1]; ++kk) {
      const int32_t k = cols[kk];
      if (k >= i) break;
      const int64_t dk = diag_pos[k];
      if (dk < 0 || vals[dk] == 0.0) return -1;
      const double lik = vals[kk] / vals[dk];
      vals[kk] = lik;
      for (int64_t jj = dk + 1; jj < indptr[k + 1]; ++jj) {
        const int64_t tgt = colmap[cols[jj]];
        if (tgt >= 0) vals[tgt] -= lik * vals[jj];
      }
    }
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) colmap[cols[p]] = -1;
  }
  return 0;
}

// IC(0): A ~= L L^T on the lower pattern of A (cf. Ginkgo
// factorization::Ic).  Input: CSR of the LOWER triangle incl. diagonal
// (row-major sorted).  vals overwritten with L.  Returns 0 / -1.
int ogl_ic0(int64_t n, const int64_t* indptr, const int32_t* cols,
            double* vals) {
  std::vector<int64_t> diag_pos(n, -1);
  std::vector<double> work(n, 0.0);
  for (int64_t i = 0; i < n; ++i) {
    // scatter row i into work
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) work[cols[p]] = vals[p];
    // columns ascend, so when entry (i,j) is processed every work[k] with
    // k < j already holds the finalised L[i,k] (zero where not in pattern)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = cols[p];
      if (j < i) {
        double s = 0.0;  // sum_{k<j} L[i,k] * L[j,k] via row j of L
        for (int64_t q = indptr[j]; q < indptr[j + 1]; ++q) {
          const int32_t k = cols[q];
          if (k >= j) break;
          s += work[k] * vals[q];
        }
        const int64_t dj = diag_pos[j];
        if (dj < 0 || vals[dj] == 0.0) return -1;
        const double lij = (work[j] - s) / vals[dj];
        work[j] = lij;
        vals[p] = lij;
      } else if (j == i) {
        double d = work[i];
        for (int64_t q = indptr[i]; q < p; ++q) {
          const double l = vals[q];
          d -= l * l;
        }
        if (d <= 0.0) d = 1e-300;
        vals[p] = std::sqrt(d);
        diag_pos[i] = p;
      }
    }
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) work[cols[p]] = 0.0;
  }
  return 0;
}

// Greedy deterministic pairwise aggregation (semantics of
// ogl_tpu.precond.amg.pgm_aggregate; cf. Ginkgo amgx_pgm at reference
// Preconditioner.H:286).  Returns the number of aggregates.
int64_t ogl_pgm_aggregate(int64_t n, const int64_t* indptr,
                          const int32_t* cols, const double* absvals,
                          int32_t* agg) {
  std::fill(agg, agg + n, -1);
  int64_t nc = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    int64_t best = -1;
    double best_w = 0.0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = cols[p];
      if (j != i && agg[j] < 0 && absvals[p] > best_w) {
        best = j;
        best_w = absvals[p];
      }
    }
    if (best >= 0) {
      agg[i] = agg[best] = static_cast<int32_t>(nc++);
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    int64_t best = -1;
    double best_w = 0.0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = cols[p];
      if (j != i && agg[j] >= 0 && absvals[p] > best_w) {
        best = j;
        best_w = absvals[p];
      }
    }
    agg[i] = (best >= 0) ? agg[best] : static_cast<int32_t>(nc++);
  }
  return nc;
}

// DIA layout, phase 1: mark which diagonals are present and return their
// count.  `present` has 2n-1 slots (shifted offset col-row+n-1); zeroed
// here.  Semantics of ogl_tpu.core.formats.dia_layout — the NumPy path
// walks ~6 full-nnz temporaries where this is two tight passes, and it
// runs on 10M+ entry arrays during first-solve setup.
int64_t ogl_dia_count(int64_t nnz, int64_t n, const int32_t* rows,
                      const int32_t* cols, uint8_t* present) {
  const int64_t ns = 2 * n - 1;
  std::memset(present, 0, static_cast<size_t>(ns));
  for (int64_t i = 0; i < nnz; ++i) {
    present[static_cast<int64_t>(cols[i]) - rows[i] + (n - 1)] = 1;
  }
  int64_t nd = 0;
  for (int64_t s = 0; s < ns; ++s) nd += present[s];
  return nd;
}

// DIA layout, phase 2: true diagonal offsets (col-row, ascending) and the
// per-entry flat destination into the (nd, n) data array
// (dest[i] = rank(diagonal of entry i) * n + row).
void ogl_dia_dest(int64_t nnz, int64_t n, const uint8_t* present,
                  const int32_t* rows, const int32_t* cols, int64_t* offs,
                  int64_t* dest) {
  const int64_t ns = 2 * n - 1;
  std::vector<int32_t> rank(static_cast<size_t>(ns), -1);
  int32_t r = 0;
  for (int64_t s = 0; s < ns; ++s) {
    if (present[s]) {
      rank[s] = r;
      offs[r] = s - (n - 1);
      ++r;
    }
  }
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t s = static_cast<int64_t>(cols[i]) - rows[i] + (n - 1);
    dest[i] = static_cast<int64_t>(rank[s]) * n + rows[i];
  }
}

// DIA pack: scatter-accumulate entry values into the zero-initialised
// (nd*n,) data array (duplicate (row,col) entries sum, like the NumPy
// bincount path; accumulation in double for parity with bincount's f64
// weights).
void ogl_dia_pack_f32(int64_t nnz, int64_t nd_times_n, const int64_t* dest,
                      const float* vals, float* data) {
  std::vector<double> acc(static_cast<size_t>(nd_times_n), 0.0);
  for (int64_t i = 0; i < nnz; ++i) acc[dest[i]] += vals[i];
  for (int64_t j = 0; j < nd_times_n; ++j)
    data[j] = static_cast<float>(acc[j]);
}

// Row-major (row, col) lexicographic sort of COO triplets with a source
// permutation output — the general-case merge used when local interfaces
// are present (reference HostMatrix.C:506-586).  O(nnz + n) counting sort.
void ogl_sort_coo(int64_t nnz, int64_t n, const int64_t* in_rows,
                  const int64_t* in_cols, int32_t* out_rows,
                  int32_t* out_cols, int32_t* out_perm) {
  std::vector<int64_t> count(n + 1, 0);
  for (int64_t e = 0; e < nnz; ++e) ++count[in_rows[e] + 1];
  for (int64_t r = 0; r < n; ++r) count[r + 1] += count[r];
  std::vector<int64_t> cursor(count.begin(), count.end() - 1);
  for (int64_t e = 0; e < nnz; ++e) {
    const int64_t p = cursor[in_rows[e]]++;
    out_rows[p] = static_cast<int32_t>(in_rows[e]);
    out_cols[p] = static_cast<int32_t>(in_cols[e]);
    out_perm[p] = static_cast<int32_t>(e);
  }
  for (int64_t r = 0; r < n; ++r) {
    const int64_t s = count[r], e = count[r + 1];
    for (int64_t i = s + 1; i < e; ++i) {
      int32_t c = out_cols[i], pm = out_perm[i];
      int64_t j = i - 1;
      while (j >= s && out_cols[j] > c) {
        out_cols[j + 1] = out_cols[j];
        out_perm[j + 1] = out_perm[j];
        --j;
      }
      out_cols[j + 1] = c;
      out_perm[j + 1] = pm;
    }
  }
}

// ISAI batch extract-and-solve (setup of ogl_tpu.precond.isai; cf. Ginkgo
// preconditioner::Isai at reference Preconditioner.H:226-259): for each row
// i with support J_i (pattern S, k-padded), build G = A[J_i, J_i] with
// identity rows/cols on padding and solve G^T m = e_i IN PLACE (Gaussian
// elimination with partial pivoting on the k x k local system) — emitting
// only the solved M rows (n, k).  Solving here instead of returning the
// (n, k, k) batch removes the setup's largest allocation (392 MB at 1M
// DOF, k=7) and a LAPACK-per-row python loop.  Singular or diagonal-less
// local systems fall back to the identity action m = e_i.
// O(n * (k * row_nnz + k^3)).
void ogl_isai_build(int64_t n, const int64_t* a_indptr, const int32_t* a_cols,
                    const float* a_vals, const int64_t* s_indptr,
                    const int32_t* s_cols, int64_t k, int32_t* J,
                    uint8_t* valid, float* M) {
  std::vector<float> work(n, 0.0f);
  std::vector<uint8_t> in_row(n, 0);
  std::vector<double> H(k * k), rhs(k);  // local solves in f64: free here
  for (int64_t i = 0; i < n; ++i) {
    const int64_t ks = s_indptr[i], ke = s_indptr[i + 1];
    const int64_t ki = ke - ks;
    int32_t* Ji = J + i * k;
    uint8_t* vi = valid + i * k;
    float* Mi = M + i * k;
    int64_t pos = 0;  // slot of column i (the unit-rhs position)
    for (int64_t a = 0; a < k; ++a) {
      Ji[a] = (a < ki) ? s_cols[ks + a] : static_cast<int32_t>(i);
      vi[a] = a < ki;
      rhs[a] = 0.0;
      if (vi[a] && Ji[a] == static_cast<int32_t>(i)) pos = a;
    }
    rhs[pos] = 1.0;
    // H = G^T built directly: H[b*k+a] = G[a][b] = A[J_a, J_b]
    for (int64_t a = 0; a < k; ++a) {
      if (!vi[a]) {
        for (int64_t b = 0; b < k; ++b) H[b * k + a] = (a == b) ? 1.0 : 0.0;
        continue;
      }
      const int64_t ra = Ji[a];
      for (int64_t p = a_indptr[ra]; p < a_indptr[ra + 1]; ++p) {
        work[a_cols[p]] = a_vals[p];
        in_row[a_cols[p]] = 1;
      }
      for (int64_t b = 0; b < k; ++b) {
        if (!vi[b]) {
          H[b * k + a] = (a == b) ? 1.0 : 0.0;
        } else {
          H[b * k + a] = in_row[Ji[b]] ? work[Ji[b]] : 0.0;
        }
      }
      for (int64_t p = a_indptr[ra]; p < a_indptr[ra + 1]; ++p) {
        work[a_cols[p]] = 0.0;
        in_row[a_cols[p]] = 0;
      }
    }
    // diagonal-less row (padded Schwarz shards): identity action
    bool ok = H[pos * k + pos] != 0.0;
    if (ok) {
      // in-place GE with partial pivoting on H, rhs
      for (int64_t c = 0; c < k && ok; ++c) {
        int64_t piv = c;
        double best = std::abs(H[c * k + c]);
        for (int64_t r2 = c + 1; r2 < k; ++r2) {
          const double v = std::abs(H[r2 * k + c]);
          if (v > best) { best = v; piv = r2; }
        }
        if (best < 1e-30) { ok = false; break; }
        if (piv != c) {
          for (int64_t b = c; b < k; ++b) std::swap(H[c * k + b], H[piv * k + b]);
          std::swap(rhs[c], rhs[piv]);
        }
        const double inv = 1.0 / H[c * k + c];
        for (int64_t r2 = c + 1; r2 < k; ++r2) {
          const double f = H[r2 * k + c] * inv;
          if (f == 0.0) continue;
          for (int64_t b = c; b < k; ++b) H[r2 * k + b] -= f * H[c * k + b];
          rhs[r2] -= f * rhs[c];
        }
      }
    }
    if (ok) {
      for (int64_t c = k - 1; c >= 0; --c) {
        double acc = rhs[c];
        for (int64_t b = c + 1; b < k; ++b) acc -= H[c * k + b] * rhs[b];
        rhs[c] = acc / H[c * k + c];
      }
      for (int64_t a = 0; a < k; ++a)
        Mi[a] = vi[a] ? static_cast<float>(rhs[a]) : 0.0f;
    } else {
      for (int64_t a = 0; a < k; ++a) Mi[a] = 0.0f;
      Mi[pos] = 1.0f;
      for (int64_t a = 0; a < k; ++a) vi[a] = 0;
      vi[pos] = 1;
    }
  }
}

// ILUT(p, tau) (threshold ILU, Saad): row-wise IKJ elimination with dual
// dropping — entries below drop_tol * ||row||_2 are discarded, and at most
// `lfil` entries are kept in each of the L and U parts of a row (largest
// magnitude; the fill cap keeps 3-D stencil factorisations O(n·lfil²)) —
// the role of Ginkgo ParIlut, reference Preconditioner.H:119-145.
// Outputs strict-L and strict-U entries as (row, col, val) triples plus the
// U diagonal.  Returns total triple count, or -1 on overflow / zero pivot.
int64_t ogl_ilut(int64_t n, const int64_t* indptr, const int32_t* cols,
                 const double* vals, double drop_tol, int64_t lfil,
                 int64_t max_nnz, int32_t* out_rows, int32_t* out_cols,
                 double* out_vals, double* out_udiag) {
  // U rows kept in CSR-ish growing storage for the update sweeps
  std::vector<std::vector<int32_t>> u_cols(n);
  std::vector<std::vector<double>> u_vals(n);
  std::vector<double> work(n, 0.0);
  std::vector<uint8_t> nz(n, 0);
  std::vector<int32_t> pattern;  // every touched column of the working row
  std::vector<int32_t> heap;     // min-heap of columns < i to eliminate
  auto cmp = [](int32_t a, int32_t b) { return a > b; };
  int64_t out = 0;
  for (int64_t i = 0; i < n; ++i) {
    pattern.clear();
    heap.clear();
    double nrm = 0.0;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = cols[p];
      work[j] = vals[p];
      if (!nz[j]) {
        nz[j] = 1;
        pattern.push_back(j);
        if (j < i) heap.push_back(j);
      }
      nrm += vals[p] * vals[p];
    }
    nrm = std::sqrt(nrm / std::max<int64_t>(indptr[i + 1] - indptr[i], 1));
    const double tau = drop_tol * nrm;
    std::make_heap(heap.begin(), heap.end(), cmp);
    // eliminate columns k < i in ascending order (fill joins the heap)
    while (!heap.empty()) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      const int32_t kk = heap.back();
      heap.pop_back();
      if (out_udiag[kk] == 0.0) return -1;
      double lik = work[kk] / out_udiag[kk];
      if (std::fabs(lik) < tau) {
        work[kk] = 0.0;  // dropped; stays in pattern, skipped at collect
        continue;
      }
      work[kk] = lik;
      const auto& uc = u_cols[kk];
      const auto& uv = u_vals[kk];
      for (size_t q = 0; q < uc.size(); ++q) {
        const int32_t j = uc[q];
        work[j] -= lik * uv[q];
        if (!nz[j]) {
          nz[j] = 1;
          pattern.push_back(j);
          if (j < i) {
            heap.push_back(j);
            std::push_heap(heap.begin(), heap.end(), cmp);
          }
        }
      }
    }
    // collect row i: threshold-drop, then keep the lfil largest-magnitude
    // entries in each of the L and U parts (diagonal always kept)
    double di = 0.0;
    std::vector<std::pair<double, int32_t>> lpart, upart;  // (|v| keyed)
    for (int32_t j : pattern) {
      const double v = work[j];
      work[j] = 0.0;
      nz[j] = 0;
      if (j == i) {
        di = v;
        continue;
      }
      if (std::fabs(v) < tau) continue;
      (j < i ? lpart : upart).emplace_back(v, j);
    }
    auto keep_largest = [lfil](std::vector<std::pair<double, int32_t>>& part) {
      if (static_cast<int64_t>(part.size()) > lfil) {
        std::nth_element(part.begin(), part.begin() + lfil, part.end(),
                         [](const auto& a, const auto& b) {
                           return std::fabs(a.first) > std::fabs(b.first);
                         });
        part.resize(lfil);
      }
      std::sort(part.begin(), part.end(),
                [](const auto& a, const auto& b) { return a.second < b.second; });
    };
    keep_largest(lpart);
    keep_largest(upart);
    for (const auto& part : {lpart, upart}) {
      for (const auto& [v, j] : part) {
        if (out >= max_nnz) return -1;
        out_rows[out] = static_cast<int32_t>(i);
        out_cols[out] = j;
        out_vals[out] = v;
        ++out;
        if (j > i) {
          u_cols[i].push_back(j);
          u_vals[i].push_back(v);
        }
      }
    }
    // a genuinely zero pivot is an error (the elimination loop checks
    // out_udiag[kk] == 0.0, so clamping here would make that check dead
    // and produce silent ~1e300 factors on singular matrices)
    if (di == 0.0) return -1;
    out_udiag[i] = di;
  }
  return out;
}

// ICT (threshold incomplete Cholesky): left-looking row factorisation with
// fill, dropping |l_ij| <= drop_tol*sqrt(a_ii*a_jj) outside A's pattern
// (the role of Ginkgo ParIct, reference Preconditioner.H:191-225; same
// algorithm as ogl_tpu.precond.ilu.ict_factor).  Outputs strict-lower
// triples + the L diagonal.  Returns triple count or -1 on overflow.
int64_t ogl_ict(int64_t n, const int64_t* indptr, const int32_t* cols,
                const double* vals, double drop_tol, int64_t max_nnz,
                int32_t* out_rows, int32_t* out_cols, double* out_vals,
                double* out_ldiag) {
  std::vector<std::vector<int32_t>> l_col_rows(n);  // column k -> rows j
  std::vector<std::vector<double>> l_col_vals(n);
  std::vector<double> scale(n, 1.0);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
      if (cols[p] == i) scale[i] = std::sqrt(std::max(std::fabs(vals[p]), 1e-300));
  std::vector<double> work(n, 0.0);
  std::vector<uint8_t> nz(n, 0), in_a(n, 0);
  int64_t out = 0;
  std::vector<int32_t> heap;
  auto cmp = [](int32_t a, int32_t b) { return a > b; };  // min-heap
  for (int64_t i = 0; i < n; ++i) {
    heap.clear();
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      const int32_t j = cols[p];
      if (j > i) break;
      work[j] = vals[p];
      nz[j] = 1;
      in_a[j] = 1;
      if (j < i) heap.push_back(j);
    }
    std::make_heap(heap.begin(), heap.end(), cmp);
    const int64_t row_start = out;
    while (!heap.empty()) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      const int32_t k = heap.back();
      heap.pop_back();
      const double lik = work[k] / out_ldiag[k];
      const bool keep =
          in_a[k] || std::fabs(lik) > drop_tol * scale[i] * scale[k];
      if (keep) {
        if (out >= max_nnz) return -1;
        out_rows[out] = static_cast<int32_t>(i);
        out_cols[out] = k;
        out_vals[out] = lik;
        ++out;
        const auto& cr = l_col_rows[k];
        const auto& cv = l_col_vals[k];
        for (size_t q = 0; q < cr.size(); ++q) {
          const int32_t j = cr[q];
          if (j <= k || j >= i) continue;
          if (nz[j]) {
            work[j] -= lik * cv[q];
          } else {
            work[j] = -lik * cv[q];
            nz[j] = 1;
            heap.push_back(j);
            std::push_heap(heap.begin(), heap.end(), cmp);
          }
        }
      }
      work[k] = 0.0;
      nz[k] = 0;
      in_a[k] = 0;
    }
    double d = work[i];
    work[i] = 0.0;
    nz[i] = 0;
    in_a[i] = 0;
    for (int64_t p = row_start; p < out; ++p) d -= out_vals[p] * out_vals[p];
    out_ldiag[i] = std::sqrt(std::max(d, 1e-300));
    for (int64_t p = row_start; p < out; ++p) {
      l_col_rows[out_cols[p]].push_back(static_cast<int32_t>(i));
      l_col_vals[out_cols[p]].push_back(out_vals[p]);
    }
  }
  return out;
}

// Dependency levels of a strict triangular factor (the port's own entry
// point; the reference computes the same levels by a fixpoint over all
// entries, ogl_tpu.precond.ilu.factor_depth): level[i] = 0 for a row
// without entries, else 1 + max level[j] over its entries (i, j).  One pass
// over the rows in dependency order: ascending for a strictly lower factor
// (every j < i), descending for a strictly upper one (every j > i).
// Returns the largest level, or -1 when the entries lie on both sides of
// the diagonal, on it, or outside [0, n).
int64_t ogl_tri_levels(int64_t n, int64_t nnz, const int64_t* rows,
                       const int64_t* cols, int32_t* level) {
  bool lower = true, upper = true;
  for (int64_t p = 0; p < nnz; ++p) {
    if (rows[p] < 0 || rows[p] >= n || cols[p] < 0 || cols[p] >= n) return -1;
    lower = lower && rows[p] > cols[p];
    upper = upper && rows[p] < cols[p];
  }
  if (nnz > 0 && !lower && !upper) return -1;
  std::vector<int64_t> ptr(n + 1, 0);
  for (int64_t p = 0; p < nnz; ++p) ++ptr[rows[p] + 1];
  for (int64_t i = 0; i < n; ++i) ptr[i + 1] += ptr[i];
  std::vector<int64_t> dep(nnz), fill(ptr.begin(), ptr.end() - 1);
  for (int64_t p = 0; p < nnz; ++p) dep[fill[rows[p]]++] = cols[p];
  int32_t depth = 0;
  for (int64_t s = 0; s < n; ++s) {
    const int64_t i = lower ? s : n - 1 - s;
    int32_t lv = 0;
    for (int64_t p = ptr[i]; p < ptr[i + 1]; ++p) lv = std::max(lv, level[dep[p]] + 1);
    level[i] = lv;
    depth = std::max(depth, lv);
  }
  return depth;
}

}  // extern "C"
