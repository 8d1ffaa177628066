// Host-side set-up of the generic sparse paths: greedy colouring, the
// dependency levels, ILU(0) / ILU(k) factorization and level pack of the
// ILDU preconditioner, the two aggregations of smoothed-aggregation AMG,
// and the one-shot CSR algebra (Gustavson SpGEMM, the sorted-row sum and
// the transpose) that builds the AMG hierarchy.
//
// The port's own copy of these functions of the JAX package's host core
// (native/sigma_host.cpp: greedy_coloring, triangular_levels,
// ilu0_factorize, pack_levels, greedy_aggregate, vmb_aggregate,
// iluk_symbolic, spgemm_fused/fetch, csr_add_symbolic/numeric,
// csr_transpose), so that the port never loads that package.  The
// algorithms, and so the results, are the same; the level pack writes the
// port's layout: each level's rows packed one after another with no
// sentinel rows, and a row's unused slots pointing at the row itself with
// value 0 (a sweep then needs no discard slot, and no target of its
// scatter collects every pad).
//
// Plain C interface for ctypes (sigma_tpu_torch/native.py), compiled with
// pruned_host.cpp into one library at first use:
//     g++ -O3 -std=c++17 -shared -fPIC pruned_host.cpp sparse_host.cpp -o libsigma_torch_host.so
// The fused SpGEMM is a two-call protocol over static buffers: the Python
// side holds a lock around the pair of calls.

#include <algorithm>
#include <cstring>
#include <vector>

using i64 = long long;

namespace {

// the fused SpGEMM's result, kept until spgemm_fetch copies it out
std::vector<i64> g_spgemm_ccol;
std::vector<double> g_spgemm_cval;

}  // namespace

extern "C" {

// Greedy first-fit colouring in vertex order; returns the number of
// colours.
i64 greedy_coloring(i64 n, const i64* indptr, const i64* indices, i64* colors) {
    std::fill(colors, colors + n, (i64)-1);
    std::vector<i64> mark(static_cast<size_t>(n), -1);
    i64 ncolors = 0;
    for (i64 v = 0; v < n; ++v) {
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
            i64 u = indices[k];
            if (colors[u] >= 0) mark[colors[u]] = v;
        }
        i64 c = 0;
        while (c < n && mark[c] == v) ++c;
        colors[v] = c;
        if (c + 1 > ncolors) ncolors = c + 1;
    }
    return ncolors;
}

// Dependency levels of a strict triangular sparsity: level[i] = 1 +
// max(level[j]) over the stored dependencies j of row i.  reverse = 0:
// lower triangular (j < i, rows taken 0..n-1); reverse = 1: upper (j > i,
// rows taken n-1..0).  Returns the number of levels.
i64 triangular_levels(i64 n, const i64* indptr, const i64* indices, i64 reverse,
                      i64* level_of) {
    i64 nlevels = n > 0 ? 1 : 0;
    i64 begin = reverse ? n - 1 : 0;
    i64 step = reverse ? -1 : 1;
    for (i64 t = 0, i = begin; t < n; ++t, i += step) {
        i64 lvl = 0;
        for (i64 k = indptr[i]; k < indptr[i + 1]; ++k) {
            i64 j = indices[k];
            bool dep = reverse ? (j > i) : (j < i);
            if (dep && level_of[j] + 1 > lvl) lvl = level_of[j] + 1;
        }
        level_of[i] = lvl;
        if (lvl + 1 > nlevels) nlevels = lvl + 1;
    }
    return nlevels;
}

// Zero-fill ILU(0) on a sorted CSR pattern, in place (SPARSKIT ikj order
// with a column-position marker): entries left of the diagonal become L
// (unit diagonal implied), the diagonal D, entries right of it the rows
// of U with D folded in.  diag_out[i] = D_i.  Returns 0, or i + 1 for a
// zero or structurally missing pivot in row i.
i64 ilu0_factorize(i64 n, const i64* indptr, const i64* indices, double* data,
                   double* diag_out) {
    std::vector<i64> ipos(static_cast<size_t>(n), -1);
    std::vector<i64> diag_pos(static_cast<size_t>(n), -1);
    for (i64 i = 0; i < n; ++i) {
        i64 s = indptr[i], e = indptr[i + 1];
        for (i64 p = s; p < e; ++p) ipos[indices[p]] = p;
        for (i64 p = s; p < e; ++p) {
            i64 k = indices[p];
            if (k >= i) break;
            double lik = data[p] / diag_out[k];
            data[p] = lik;
            for (i64 kp = diag_pos[k] + 1; kp < indptr[k + 1]; ++kp) {
                i64 pos = ipos[indices[kp]];
                if (pos >= 0) data[pos] -= lik * data[kp];
            }
        }
        i64 dp = diag_pos[i] = ipos[i];
        for (i64 p = s; p < e; ++p) ipos[indices[p]] = -1;
        if (dp < 0 || data[dp] == 0.0) return i + 1;
        diag_out[i] = data[dp];
    }
    return 0;
}

// Pack a strict triangular CSR system by dependency level for the sweeps:
// level l's rows take slots level_ptr[l] .. level_ptr[l + 1] - 1 in
// ascending row order (rows_out, n long); row i's entries fill its
// ``width`` slots of cols_out / vals_out (n * width) and the rest hold i
// and 0.
void pack_levels(i64 n, const i64* indptr, const i64* indices, const double* data,
                 const i64* level, i64 nlev, const i64* level_ptr, i64 width,
                 i64* rows_out, i64* cols_out, double* vals_out) {
    std::vector<i64> slot(level_ptr, level_ptr + nlev);
    for (i64 i = 0; i < n; ++i) {
        i64 s = slot[level[i]]++;
        rows_out[s] = i;
        i64 base = s * width;
        i64 p = indptr[i], e = indptr[i + 1];
        for (i64 w = 0; w < width; ++w, ++p) {
            cols_out[base + w] = p < e ? indices[p] : i;
            vals_out[base + w] = p < e ? data[p] : 0.0;
        }
    }
}

// Greedy aggregation: each unaggregated vertex in order seeds an aggregate
// with its unaggregated neighbours.  Returns the number of aggregates.
i64 greedy_aggregate(i64 n, const i64* indptr, const i64* indices, i64* agg) {
    std::fill(agg, agg + n, (i64)-1);
    i64 next_agg = 0;
    for (i64 v = 0; v < n; ++v) {
        if (agg[v] >= 0) continue;
        agg[v] = next_agg;
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
            i64 u = indices[k];
            if (agg[u] < 0) agg[u] = next_agg;
        }
        ++next_agg;
    }
    return next_agg;
}

// VMB (Vanek-Mandel-Brezina) aggregation: phase 1 seeds an aggregate at a
// vertex only when its whole neighbourhood is unaggregated, phase 2
// attaches leftovers to an adjacent aggregate, phase 3 seeds the rest from
// their unaggregated neighbours.  Returns the number of aggregates.
i64 vmb_aggregate(i64 n, const i64* indptr, const i64* indices, i64* agg) {
    std::fill(agg, agg + n, (i64)-1);
    i64 next_agg = 0;
    for (i64 v = 0; v < n; ++v) {  // phase 1
        if (agg[v] >= 0) continue;
        bool clean = true;
        for (i64 k = indptr[v]; k < indptr[v + 1] && clean; ++k)
            if (indices[k] != v && agg[indices[k]] >= 0) clean = false;
        if (!clean) continue;
        agg[v] = next_agg;
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) agg[indices[k]] = next_agg;
        ++next_agg;
    }
    for (i64 v = 0; v < n; ++v) {  // phase 2
        if (agg[v] >= 0) continue;
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
            i64 a = agg[indices[k]];
            if (a >= 0) {
                agg[v] = a;
                break;
            }
        }
    }
    for (i64 v = 0; v < n; ++v) {  // phase 3
        if (agg[v] >= 0) continue;
        agg[v] = next_agg;
        for (i64 k = indptr[v]; k < indptr[v + 1]; ++k)
            if (agg[indices[k]] < 0) agg[indices[k]] = next_agg;
        ++next_agg;
    }
    return next_agg;
}

// ILU(k) symbolic factorization: the level-of-fill pattern (Saad,
// Iterative Methods, 10.3.3).  Per row: seed with A's pattern at level 0,
// then for each kept column j < i in ascending order merge row j's upper
// factor pattern with lev = lev(i, j) + lev(j, l) + 1, keeping lev <= k;
// a linked list through the columns gives ascending traversal with O(1)
// insertion.  Writes the factor's pattern (L + diag + U, sorted rows) and
// returns nnz(F) if it fits cap, else -(nnz needed) for a retry.
i64 iluk_symbolic(i64 n, const i64* indptr, const i64* indices, i64 k, i64 cap,
                  i64* fptr, i64* fcol) {
    std::vector<std::vector<i64>> ucols(static_cast<size_t>(n));
    std::vector<std::vector<i64>> ulev(static_cast<size_t>(n));
    const i64 INF = (i64)1 << 60;
    std::vector<i64> lev(static_cast<size_t>(n), INF);
    std::vector<i64> nxt(static_cast<size_t>(n) + 1, -1);  // linked list
    std::vector<i64> out;
    out.reserve(static_cast<size_t>(indptr[n]));
    std::vector<i64> optr(static_cast<size_t>(n) + 1, 0);

    for (i64 i = 0; i < n; ++i) {
        // seed the list with row i of A (sorted); n is the head sentinel
        i64 head = n;
        nxt[n] = -1;
        i64 prev = n;
        for (i64 p = indptr[i]; p < indptr[i + 1]; ++p) {
            i64 c = indices[p];
            lev[c] = 0;
            nxt[prev] = c;
            nxt[c] = -1;
            prev = c;
        }
        for (i64 j = nxt[head]; j != -1 && j < i; j = nxt[j]) {
            i64 levij = lev[j];
            if (levij > k) continue;
            const auto& uc = ucols[j];
            const auto& ul = ulev[j];
            i64 ins = j;  // insertion cursor: uc is ascending and > j
            for (size_t t = 0; t < uc.size(); ++t) {
                i64 l = uc[t];
                i64 nl = levij + ul[t] + 1;
                if (lev[l] == INF) {
                    if (nl > k) continue;
                    lev[l] = nl;
                    while (nxt[ins] != -1 && nxt[ins] < l) ins = nxt[ins];
                    nxt[l] = nxt[ins];
                    nxt[ins] = l;
                } else if (nl < lev[l]) {
                    lev[l] = nl;
                }
            }
        }
        for (i64 c = nxt[head]; c != -1; c = nxt[c]) {
            if (lev[c] <= k) {
                out.push_back(c);
                if (c > i) {
                    ucols[i].push_back(c);
                    ulev[i].push_back(lev[c]);
                }
            }
        }
        optr[i + 1] = static_cast<i64>(out.size());
        for (i64 c = nxt[head]; c != -1;) {  // reset the touched columns
            i64 c2 = nxt[c];
            lev[c] = INF;
            nxt[c] = -1;
            c = c2;
        }
    }
    i64 total = static_cast<i64>(out.size());
    if (total > cap) return -total;
    std::memcpy(fptr, optr.data(), sizeof(i64) * (n + 1));
    std::memcpy(fcol, out.data(), sizeof(i64) * total);
    return total;
}

// C = A (n x k) @ B (k x m) for row-sorted CSR operands in one Gustavson
// pass (a sparse accumulator, columns sorted within each row): writes
// C's row pointer, keeps its columns and values for spgemm_fetch, and
// returns nnz(C).
i64 spgemm_fused(i64 n, i64 m, const i64* aptr, const i64* acol, const double* aval,
                 const i64* bptr, const i64* bcol, const double* bval, i64* cptr) {
    std::vector<double> spa(static_cast<size_t>(m), 0.0);
    std::vector<i64> mark(static_cast<size_t>(m), -1);
    std::vector<i64> row_cols;
    g_spgemm_ccol.clear();
    g_spgemm_cval.clear();
    cptr[0] = 0;
    for (i64 i = 0; i < n; ++i) {
        row_cols.clear();
        for (i64 p = aptr[i]; p < aptr[i + 1]; ++p) {
            i64 k = acol[p];
            double a = aval[p];
            for (i64 q = bptr[k]; q < bptr[k + 1]; ++q) {
                i64 j = bcol[q];
                if (mark[j] != i) {
                    mark[j] = i;
                    spa[j] = a * bval[q];
                    row_cols.push_back(j);
                } else {
                    spa[j] += a * bval[q];
                }
            }
        }
        std::sort(row_cols.begin(), row_cols.end());
        for (i64 j : row_cols) {
            g_spgemm_ccol.push_back(j);
            g_spgemm_cval.push_back(spa[j]);
        }
        cptr[i + 1] = static_cast<i64>(g_spgemm_ccol.size());
    }
    return cptr[n];
}

void spgemm_fetch(i64 nnz, i64* ccol, double* cval) {
    std::copy_n(g_spgemm_ccol.data(), static_cast<size_t>(nnz), ccol);
    std::copy_n(g_spgemm_cval.data(), static_cast<size_t>(nnz), cval);
}

// C = alpha A + beta B on the union sparsity of two row-sorted CSR
// operands: the row pointer and nnz(C) ...
i64 csr_add_symbolic(i64 n, const i64* aptr, const i64* acol, const i64* bptr,
                     const i64* bcol, i64* cptr) {
    cptr[0] = 0;
    for (i64 i = 0; i < n; ++i) {
        i64 pa = aptr[i], ea = aptr[i + 1];
        i64 pb = bptr[i], eb = bptr[i + 1];
        i64 cnt = 0;
        while (pa < ea || pb < eb) {
            if (pb >= eb || (pa < ea && acol[pa] < bcol[pb])) ++pa;
            else if (pa >= ea || bcol[pb] < acol[pa]) ++pb;
            else {
                ++pa;
                ++pb;
            }
            ++cnt;
        }
        cptr[i + 1] = cptr[i] + cnt;
    }
    return cptr[n];
}

// ... then its sorted columns and values.
void csr_add_numeric(i64 n, double alpha, double beta, const i64* aptr, const i64* acol,
                     const double* aval, const i64* bptr, const i64* bcol,
                     const double* bval, const i64* cptr, i64* ccol, double* cval) {
    for (i64 i = 0; i < n; ++i) {
        i64 pa = aptr[i], ea = aptr[i + 1];
        i64 pb = bptr[i], eb = bptr[i + 1];
        i64 w = cptr[i];
        while (pa < ea || pb < eb) {
            if (pb >= eb || (pa < ea && acol[pa] < bcol[pb])) {
                ccol[w] = acol[pa];
                cval[w] = alpha * aval[pa++];
            } else if (pa >= ea || bcol[pb] < acol[pa]) {
                ccol[w] = bcol[pb];
                cval[w] = beta * bval[pb++];
            } else {
                ccol[w] = acol[pa];
                cval[w] = alpha * aval[pa++] + beta * bval[pb++];
            }
            ++w;
        }
    }
}

// T = A^T of an (n x m) row-sorted CSR by a counting sort over columns;
// T's rows come out sorted because the scan is in row order.
void csr_transpose(i64 n, i64 m, const i64* aptr, const i64* acol, const double* aval,
                   i64* tptr, i64* tcol, double* tval) {
    std::fill(tptr, tptr + m + 1, (i64)0);
    i64 ne = aptr[n];
    for (i64 p = 0; p < ne; ++p) tptr[acol[p] + 1]++;
    for (i64 j = 0; j < m; ++j) tptr[j + 1] += tptr[j];
    std::vector<i64> next(tptr, tptr + m);
    for (i64 i = 0; i < n; ++i)
        for (i64 p = aptr[i]; p < aptr[i + 1]; ++p) {
            i64 w = next[acol[p]]++;
            tcol[w] = i;
            tval[w] = aval[p];
        }
}

}  // extern "C"
