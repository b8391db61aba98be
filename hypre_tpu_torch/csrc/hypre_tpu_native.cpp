// Native host-side AMG setup kernels (C++/OpenMP).
//
// The solve phase of hypre_tpu runs on TPU through XLA/Pallas; the *setup*
// phase (strength graphs, coarsening, interpolation assembly, Galerkin
// triple products) is irregular graph work the reference implements in C
// (parcsr_ls/par_strength.c, par_coarsen.c, par_lr_interp.c, par_rap.c,
// seq_mv/csr_spgemm_*). These are their shared-memory C++ equivalents,
// operating on plain CSR arrays passed from Python via ctypes. Gustavson
// row-merge with per-thread dense accumulators replaces hypre's GPU hash
// tables; OpenMP replaces MPI ranks within the host.
//
// All indices are int32, values double. Every function is exported with C
// linkage for ctypes.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>
#include <queue>

#ifdef _OPENMP
#include <omp.h>
#else
static int omp_get_max_threads() { return 1; }
static int omp_get_thread_num() { return 0; }
#endif

using i32 = int32_t;
using f64 = double;

extern "C" {

// ---------------------------------------------------------------------------
// strength of connection (hypre_BoomerAMGCreateS, par_strength.c:531)
// S_mask[p] = 1 iff A entry p is a strong off-diagonal connection.
// ---------------------------------------------------------------------------
void strength_mask(i32 n, const i32* Ap, const i32* Aj, const f64* Ax,
                   f64 theta, f64 max_row_sum, uint8_t* S_mask) {
#pragma omp parallel for schedule(static)
  for (i32 i = 0; i < n; ++i) {
    f64 diag = 0.0, row_sum = 0.0;
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
      row_sum += Ax[p];
      if (Aj[p] == i) diag += Ax[p];
    }
    // diagonally dominant row (|row_sum| > max_row_sum*|diag|): pointwise
    // relaxation handles it alone; drop all dependencies (par_strength.c
    // max_row_sum branch, HYPRE_BoomerAMGSetMaxRowSum default 0.9)
    bool dominant =
        max_row_sum < 1.0 && std::fabs(row_sum) > max_row_sum * std::fabs(diag);
    f64 sign = diag >= 0 ? 1.0 : -1.0;
    f64 row_max = 0.0;
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
      if (Aj[p] == i) continue;
      f64 cand = -sign * Ax[p];
      if (cand > row_max) row_max = cand;
    }
    f64 thresh = theta * row_max;
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
      f64 cand = -sign * Ax[p];
      S_mask[p] = (!dominant && Aj[p] != i && row_max > 0 && cand > 0 &&
                   cand >= thresh);
    }
  }
}

// ---------------------------------------------------------------------------
// PMIS coarsening (par_coarsen.c:2813). Same stateless hash tie-breaker as
// core/config.py:hash_rand01 so jax and native produce identical CF markers.
// cf: +1 C, -1 F.
// ---------------------------------------------------------------------------
static inline f64 hash01(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x = x ^ (x >> 16);
  return (f64)x / 4294967296.0;
}

void pmis_coarsen(i32 n, const i32* Ap, const i32* Aj, const uint8_t* S_mask,
                  i32 row_offset, i32* cf) {
  // measure = |S^T_i| + hash(i)
  std::vector<f64> measure(n);
  std::vector<i32> st_count(n, 0);
  for (i32 i = 0; i < n; ++i)
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p)
      if (S_mask[p]) st_count[Aj[p]]++;
#pragma omp parallel for schedule(static)
  for (i32 i = 0; i < n; ++i) {
    measure[i] = st_count[i] + hash01((uint32_t)(i + row_offset));
    bool has_strong_row = false;
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p)
      if (S_mask[p]) { has_strong_row = true; break; }
    cf[i] = (!has_strong_row && st_count[i] == 0) ? -1 : 0;
  }

  while (true) {
    i32 undecided = 0;
    for (i32 i = 0; i < n; ++i) undecided += (cf[i] == 0);
    if (undecided == 0) break;

    // C selection: strict local maxima of measure over undecided strength
    // neighbors in S_i (row direction) and S^T_i (column direction)
    std::vector<uint8_t> new_c(n, 0);
#pragma omp parallel for schedule(static)
    for (i32 i = 0; i < n; ++i) {
      if (cf[i] != 0) continue;
      f64 m = measure[i];
      if (m <= 0) continue;
      bool best = true;
      for (i32 p = Ap[i]; p < Ap[i + 1] && best; ++p)
        if (S_mask[p] && cf[Aj[p]] == 0 && Aj[p] != i && measure[Aj[p]] >= m)
          best = false;
      new_c[i] = best;
    }
    for (i32 i = 0; i < n; ++i) {  // serial S^T pass
      if (cf[i] != 0) continue;
      for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
        i32 j = Aj[p];
        if (S_mask[p] && j != i && cf[j] == 0 && new_c[j] &&
            measure[i] >= measure[j])
          new_c[j] = 0;
      }
    }
    i32 n_decided = 0;
    for (i32 i = 0; i < n; ++i)
      if (new_c[i] && cf[i] == 0) { cf[i] = 1; ++n_decided; }
    // F assignment: undecided points strongly depending on a C point
#pragma omp parallel for schedule(static) reduction(+ : n_decided)
    for (i32 i = 0; i < n; ++i) {
      if (cf[i] != 0) continue;
      for (i32 p = Ap[i]; p < Ap[i + 1]; ++p)
        if (S_mask[p] && cf[Aj[p]] == 1) {
          cf[i] = -1;
          ++n_decided;
          break;
        }
    }
    if (n_decided == 0) {  // stall guard (pathological ties)
      for (i32 i = 0; i < n; ++i)
        if (cf[i] == 0) cf[i] = 1;
    }
  }
}

// ---------------------------------------------------------------------------
// Ruge-Stuben first pass (par_coarsen.c:908) — greedy max-measure heap.
// ---------------------------------------------------------------------------
void rs_coarsen(i32 n, const i32* Ap, const i32* Aj, const uint8_t* S_mask,
                i32* cf) {
  std::vector<std::vector<i32>> inf(n);  // S^T adjacency
  std::vector<i32> measure(n, 0);
  for (i32 i = 0; i < n; ++i)
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p)
      if (S_mask[p]) { inf[Aj[p]].push_back(i); measure[Aj[p]]++; }
  std::fill(cf, cf + n, 0);
  using Item = std::pair<i32, i32>;  // (measure, node)
  std::priority_queue<Item> heap;
  for (i32 i = 0; i < n; ++i) heap.push({measure[i], i});
  while (!heap.empty()) {
    auto [m, i] = heap.top();
    heap.pop();
    if (cf[i] != 0 || m != measure[i]) continue;
    if (measure[i] <= 0) { cf[i] = -1; continue; }
    cf[i] = 1;
    for (i32 j : inf[i]) {
      if (cf[j] != 0) continue;
      cf[j] = -1;
      for (i32 p = Ap[j]; p < Ap[j + 1]; ++p)
        if (S_mask[p] && cf[Aj[p]] == 0) {
          measure[Aj[p]]++;
          heap.push({measure[Aj[p]], Aj[p]});
        }
    }
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p)
      if (S_mask[p] && cf[Aj[p]] == 0) {
        measure[Aj[p]]--;
        heap.push({measure[Aj[p]], Aj[p]});
      }
  }
  for (i32 i = 0; i < n; ++i)
    if (cf[i] == 0) cf[i] = -1;
}

// ---------------------------------------------------------------------------
// SpGEMM (Gustavson; replaces seq_mv/csr_spgemm_device.c's hash kernels)
// ---------------------------------------------------------------------------
void spgemm_symbolic(i32 n, i32 m, const i32* Ap, const i32* Aj,
                     const i32* Bp, const i32* Bj, i32* Cp) {
#pragma omp parallel
  {
    std::vector<i32> marker(m, -1);
#pragma omp for schedule(dynamic, 256)
    for (i32 i = 0; i < n; ++i) {
      i32 count = 0;
      for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
        i32 j = Aj[p];
        for (i32 q = Bp[j]; q < Bp[j + 1]; ++q) {
          i32 k = Bj[q];
          if (marker[k] != i) { marker[k] = i; ++count; }
        }
      }
      Cp[i + 1] = count;
    }
  }
  Cp[0] = 0;
  for (i32 i = 0; i < n; ++i) Cp[i + 1] += Cp[i];
}

void spgemm_numeric(i32 n, i32 m, const i32* Ap, const i32* Aj, const f64* Ax,
                    const i32* Bp, const i32* Bj, const f64* Bx,
                    const i32* Cp, i32* Cj, f64* Cx) {
#pragma omp parallel
  {
    std::vector<i32> marker(m, -1);
    std::vector<i32> cols;
#pragma omp for schedule(dynamic, 256)
    for (i32 i = 0; i < n; ++i) {
      cols.clear();
      for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
        i32 j = Aj[p];
        for (i32 q = Bp[j]; q < Bp[j + 1]; ++q)
          if (marker[Bj[q]] != i) { marker[Bj[q]] = i; cols.push_back(Bj[q]); }
      }
      std::sort(cols.begin(), cols.end());
      i32 base = Cp[i];
      for (i32 t = 0; t < (i32)cols.size(); ++t) {
        Cj[base + t] = cols[t];
        Cx[base + t] = 0.0;
        marker[cols[t]] = base + t;  // marker now holds the output slot
      }
      for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
        i32 j = Aj[p];
        f64 v = Ax[p];
        for (i32 q = Bp[j]; q < Bp[j + 1]; ++q) Cx[marker[Bj[q]]] += v * Bx[q];
      }
      for (i32 c : cols) marker[c] = -1;
    }
  }
}

// ---------------------------------------------------------------------------
// CSR transpose (counting sort; csr_sptrans_device.c analogue)
// ---------------------------------------------------------------------------
void csr_transpose(i32 n, i32 m, const i32* Ap, const i32* Aj, const f64* Ax,
                   i32* Tp, i32* Tj, f64* Tx) {
  i32 nnz = Ap[n];
  std::vector<i32> count(m + 1, 0);
  for (i32 p = 0; p < nnz; ++p) count[Aj[p] + 1]++;
  for (i32 j = 0; j < m; ++j) count[j + 1] += count[j];
  std::memcpy(Tp, count.data(), sizeof(i32) * (m + 1));
  std::vector<i32> cursor(count.begin(), count.end() - 1);
  for (i32 i = 0; i < n; ++i)
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
      i32 dst = cursor[Aj[p]]++;
      Tj[dst] = i;
      Tx[dst] = Ax[p];
    }
}

// ---------------------------------------------------------------------------
// Extended+i interpolation, modified MM form (par_lr_interp.c /
// par_mod_lr_interp.c; formula documented in amg/interp.py). Two-call
// symbolic/numeric pattern like SpGEMM.
// ---------------------------------------------------------------------------
void extpi_symbolic(i32 n, const i32* Ap, const i32* Aj,
                    const uint8_t* S_mask, const i32* cf, i32* Pp) {
#pragma omp parallel
  {
    std::vector<i32> marker(n, -1);
#pragma omp for schedule(dynamic, 256)
    for (i32 i = 0; i < n; ++i) {
      if (cf[i] == 1) { Pp[i + 1] = 1; continue; }
      i32 count = 0;
      for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
        if (!S_mask[p]) continue;
        i32 j = Aj[p];
        if (cf[j] == 1) {
          if (marker[j] != i) { marker[j] = i; ++count; }
        } else {
          for (i32 q = Ap[j]; q < Ap[j + 1]; ++q)
            if (S_mask[q] && cf[Aj[q]] == 1 && marker[Aj[q]] != i) {
              marker[Aj[q]] = i;
              ++count;
            }
        }
      }
      Pp[i + 1] = count;
    }
  }
  Pp[0] = 0;
  for (i32 i = 0; i < n; ++i) Pp[i + 1] += Pp[i];
}

void extpi_numeric(i32 n, const i32* Ap, const i32* Aj, const f64* Ax,
                   const uint8_t* S_mask, const i32* cf, const i32* cmap,
                   const i32* Pp, i32* Pj, f64* Px) {
  // a_hat: entries sign-opposed to the row diagonal
  std::vector<f64> diag(n, 0.0);
#pragma omp parallel for schedule(static)
  for (i32 i = 0; i < n; ++i)
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p)
      if (Aj[p] == i) diag[i] += Ax[p];

#pragma omp parallel
  {
    std::vector<f64> w(n, 0.0);
    std::vector<i32> marker(n, -1);
    std::vector<i32> cols;
    std::vector<i32> jc_buf;   // strong-C columns of the neighbor row
    std::vector<f64> ja_buf;   // their a_hat values
#pragma omp for schedule(dynamic, 256)
    for (i32 i = 0; i < n; ++i) {
      if (cf[i] == 1) {
        Pj[Pp[i]] = cmap[i];
        Px[Pp[i]] = 1.0;
        continue;
      }
      cols.clear();
      f64 d_eff = diag[i];
      for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
        i32 j = Aj[p];
        if (j == i) continue;
        f64 a_ij = Ax[p];
        if (!S_mask[p]) {       // weak: lump onto diagonal
          d_eff += a_ij;
          continue;
        }
        if (cf[j] == 1) {       // strong C: direct candidate
          if (marker[j] != i) { marker[j] = i; w[j] = 0.0; cols.push_back(j); }
          w[j] += a_ij;
        } else {                // strong F: distribute through row j —
          // single scan of row j caching its strong-C a_hat entries
          f64 sign_j = diag[j] >= 0 ? 1.0 : -1.0;
          f64 theta = 0.0, back = 0.0;
          jc_buf.clear();
          ja_buf.clear();
          for (i32 q = Ap[j]; q < Ap[j + 1]; ++q) {
            f64 ahat = (Ax[q] * sign_j < 0) ? Ax[q] : 0.0;
            if (Aj[q] == i) back += ahat;
            if (ahat != 0.0 && S_mask[q] && cf[Aj[q]] == 1) {
              theta += ahat;
              jc_buf.push_back(Aj[q]);
              ja_buf.push_back(ahat);
            }
          }
          theta += back;
          if (theta == 0.0) { d_eff += a_ij; continue; }
          d_eff += a_ij * back / theta;
          f64 scale = a_ij / theta;
          for (size_t t = 0; t < jc_buf.size(); ++t) {
            i32 c = jc_buf[t];
            if (marker[c] != i) { marker[c] = i; w[c] = 0.0; cols.push_back(c); }
            w[c] += scale * ja_buf[t];
          }
        }
      }
      std::sort(cols.begin(), cols.end());
      f64 d_safe = d_eff != 0.0 ? d_eff : 1.0;
      i32 out = Pp[i];
      for (i32 c : cols) {
        Pj[out] = cmap[c];
        Px[out] = -w[c] / d_safe;
        ++out;
      }
      // symbolic counts every strong-C neighbor entry, numeric keeps only
      // sign-filtered (a_hat) ones with theta != 0 — mark the unused tail
      // with a sentinel column the caller compacts away (keeps P's rows in
      // sorted column order with no spurious (0, 0.0) entries)
      for (; out < Pp[i + 1]; ++out) {
        Pj[out] = -1;
        Px[out] = 0.0;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Interpolation truncation (par_interp_trunc_device.c): keep the max_elmts
// largest |w| per row (and |w| >= trunc_factor * max|w|), rescale to
// preserve row sums. In-place on a CSR: returns new nnz, compacting arrays.
// ---------------------------------------------------------------------------
i32 interp_truncate(i32 n, i32* Pp, i32* Pj, f64* Px, i32 max_elmts,
                    f64 trunc_factor) {
  std::vector<i32> new_p(n + 1, 0);
  std::vector<i32> keep_idx;
  keep_idx.reserve(Pp[n]);
  for (i32 i = 0; i < n; ++i) {
    i32 lo = Pp[i], hi = Pp[i + 1];
    i32 len = hi - lo;
    std::vector<i32> order(len);
    for (i32 t = 0; t < len; ++t) order[t] = lo + t;
    f64 row_sum = 0.0, max_abs = 0.0;
    for (i32 p = lo; p < hi; ++p) {
      row_sum += Px[p];
      max_abs = std::max(max_abs, std::fabs(Px[p]));
    }
    std::sort(order.begin(), order.end(), [&](i32 a, i32 b) {
      return std::fabs(Px[a]) > std::fabs(Px[b]);
    });
    i32 cap = (max_elmts > 0 && max_elmts < len) ? max_elmts : len;
    std::vector<i32> kept;
    f64 new_sum = 0.0;
    for (i32 t = 0; t < cap; ++t) {
      i32 p = order[t];
      if (trunc_factor > 0 && std::fabs(Px[p]) < trunc_factor * max_abs)
        continue;
      kept.push_back(p);
      new_sum += Px[p];
    }
    f64 scale = (new_sum != 0.0) ? row_sum / new_sum : 1.0;
    std::sort(kept.begin(), kept.end(),
              [&](i32 a, i32 b) { return Pj[a] < Pj[b]; });
    for (i32 p : kept) keep_idx.push_back(p);
    new_p[i + 1] = (i32)keep_idx.size();
    for (size_t t = keep_idx.size() - kept.size(); t < keep_idx.size(); ++t)
      Px[keep_idx[t]] *= scale;
  }
  // compact
  for (i32 t = 0; t < (i32)keep_idx.size(); ++t) {
    Pj[t] = Pj[keep_idx[t]];
    Px[t] = Px[keep_idx[t]];
  }
  std::memcpy(Pp, new_p.data(), sizeof(i32) * (n + 1));
  return (i32)keep_idx.size();
}

}  // extern "C"

extern "C" {
// CSR SpMV (host; used by setup-phase eigenvalue estimates and oracles)
void csr_matvec(i32 n, const i32* Ap, const i32* Aj, const f64* Ax,
                const f64* x, f64* y) {
#pragma omp parallel for schedule(static)
  for (i32 i = 0; i < n; ++i) {
    f64 acc = 0.0;
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) acc += Ax[p] * x[Aj[p]];
    y[i] = acc;
  }
}
}  // extern "C"

extern "C" {
// ---------------------------------------------------------------------------
// Direct interpolation (hypre_BoomerAMGBuildDirInterp, par_interp.c; the
// benchmark_ij.jobs "-interptype 3" configuration). Row-local: no neighbor
// row gathers, so P is as sparse as the strong-C pattern.
// ---------------------------------------------------------------------------
void direct_symbolic(i32 n, const i32* Ap, const i32* Aj,
                     const uint8_t* S_mask, const i32* cf, i32* Pp) {
#pragma omp parallel for schedule(static)
  for (i32 i = 0; i < n; ++i) {
    if (cf[i] == 1) { Pp[i + 1] = 1; continue; }
    i32 count = 0;
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p)
      if (S_mask[p] && cf[Aj[p]] == 1) ++count;
    Pp[i + 1] = count;
  }
  Pp[0] = 0;
  for (i32 i = 0; i < n; ++i) Pp[i + 1] += Pp[i];
}

void direct_numeric(i32 n, const i32* Ap, const i32* Aj, const f64* Ax,
                    const uint8_t* S_mask, const i32* cf, const i32* cmap,
                    const i32* Pp, i32* Pj, f64* Px) {
#pragma omp parallel for schedule(dynamic, 256)
  for (i32 i = 0; i < n; ++i) {
    if (cf[i] == 1) {
      Pj[Pp[i]] = cmap[i];
      Px[Pp[i]] = 1.0;
      continue;
    }
    f64 diag = 0.0, sum_n_neg = 0.0, sum_n_pos = 0.0;
    f64 sum_p_neg = 0.0, sum_p_pos = 0.0;
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
      i32 j = Aj[p];
      f64 v = Ax[p];
      if (j == i) { diag += v; continue; }
      if (v < 0) sum_n_neg += v; else sum_n_pos += v;
      if (S_mask[p] && cf[j] == 1) {
        if (v < 0) sum_p_neg += v; else sum_p_pos += v;
      }
    }
    bool have_pos_c = sum_p_pos != 0.0;
    f64 d_eff = have_pos_c ? diag : diag + sum_n_pos;
    f64 alfa = sum_p_neg != 0.0 ? sum_n_neg / sum_p_neg : 0.0;
    f64 beta = have_pos_c ? sum_n_pos / sum_p_pos : 0.0;
    f64 d_safe = d_eff != 0.0 ? d_eff : 1.0;
    i32 out = Pp[i];
    for (i32 p = Ap[i]; p < Ap[i + 1]; ++p) {
      if (!(S_mask[p] && cf[Aj[p]] == 1)) continue;
      f64 v = Ax[p];
      f64 w = (v < 0 ? -alfa * v : -beta * v) / d_safe;
      Pj[out] = cmap[Aj[p]];
      Px[out] = w;
      ++out;
    }
  }
}
}  // extern "C"
