// Host-side set-up of the unstructured pruned path: adjacency, the
// breadth-first, reverse Cuthill-McKee and Sloan orderings, the pruned
// block-DIA pack and the 1-D pair coarsening of the multigrid hierarchy.
//
// The port's own copy of six function families of the JAX package's host
// core (native/sigma_host.cpp: adjacency_from_coo, bfs_order, rcm_order,
// sloan_order, pack_pruned_count/active/fill, coarsen_pair_count/fetch),
// so that the port never loads that package.  The algorithms, and so the
// results, are
// the same; the pack's fill writes the port's layout (one signed offset
// per slot and per-tile slot ranges instead of the TPU's window positions
// and first-step flags) in float32 or float64 from the same sorted pass.
//
// Plain C interface for ctypes (sigma_tpu_torch/native.py), built with the
// host C++ compiler at first use:
//     g++ -O3 -std=c++17 -shared -fPIC pruned_host.cpp -o libsigma_torch_host.so
// The pack and the coarsening are two-call protocols over static buffers:
// the Python side holds a lock around each pair of calls.

#include <algorithm>
#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

using i64 = long long;
using u64 = unsigned long long;

namespace {

constexpr int kRadixBits = 16;
constexpr size_t kBuckets = size_t(1) << kRadixBits;

// ascending degree, ties by vertex id
struct ByDegree {
    const std::vector<i64>& deg;
    bool operator()(i64 a, i64 b) const {
        return deg[a] < deg[b] || (deg[a] == deg[b] && a < b);
    }
};

std::vector<u64> g_pp_keys;
std::vector<double> g_pp_vals;
std::vector<i64> g_pp_rloc;
std::vector<i64> g_pp_cnt;  // active (tile, offset) pairs per tile
i64 g_pp_reach = 0, g_pp_G = 0;

std::vector<u64> g_cp_keys;
std::vector<double> g_cp_vals;

}  // namespace

extern "C" {

// Row-grouped adjacency of duplicate-free COO edges: a counting sort by
// row (within-row order is the input order; no dedup).  out_cols holds ne
// entries, indptr n + 1.
void adjacency_from_coo(i64 n, i64 ne, const i64* rows, const i64* cols,
                        i64* out_cols, i64* indptr) {
    for (i64 i = 0; i <= n; ++i) indptr[i] = 0;
    for (i64 e = 0; e < ne; ++e) indptr[rows[e] + 1]++;
    for (i64 i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
    std::vector<i64> pos(indptr, indptr + n);
    for (i64 e = 0; e < ne; ++e) out_cols[pos[rows[e]]++] = cols[e];
}

// Breadth-first visit ranks (perm[v] = visit rank) from ``start``,
// restarting at the lowest unvisited vertex; neighbours in adjacency order.
void bfs_order(i64 n, const i64* indptr, const i64* indices, i64 start, i64* perm) {
    std::vector<char> seen(static_cast<size_t>(n), 0);
    std::vector<i64> queue;
    queue.reserve(static_cast<size_t>(n));
    i64 rank = 0, scan = 0, s = start;
    while (rank < n) {
        if (s < 0) {
            while (scan < n && seen[scan]) ++scan;
            if (scan >= n) break;
            s = scan;
        }
        queue.clear();
        queue.push_back(s);
        seen[s] = 1;
        for (size_t q = 0; q < queue.size(); ++q) {
            i64 v = queue[q];
            perm[v] = rank++;
            for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
                i64 u = indices[k];
                if (!seen[u]) {
                    seen[u] = 1;
                    queue.push_back(u);
                }
            }
        }
        s = -1;
    }
}

// Reverse Cuthill-McKee: BFS from a minimum-degree vertex per component
// (components in order of that vertex), neighbours in ascending-degree
// order, ranks reversed.  perm[v] = new label of v (scatter form).
void rcm_order(i64 n, const i64* indptr, const i64* indices, i64* perm) {
    std::vector<i64> deg(static_cast<size_t>(n));
    for (i64 v = 0; v < n; ++v) deg[v] = indptr[v + 1] - indptr[v];
    const ByDegree by_degree{deg};
    std::vector<char> seen(static_cast<size_t>(n), 0);
    std::vector<i64> queue;
    queue.reserve(static_cast<size_t>(n));
    std::vector<i64> nbrs;
    i64 rank = 0;
    std::vector<i64> verts(static_cast<size_t>(n));
    for (i64 v = 0; v < n; ++v) verts[v] = v;
    std::sort(verts.begin(), verts.end(), by_degree);
    for (i64 s : verts) {
        if (seen[s]) continue;
        queue.clear();
        queue.push_back(s);
        seen[s] = 1;
        for (size_t q = 0; q < queue.size(); ++q) {
            i64 v = queue[q];
            perm[v] = rank++;
            nbrs.clear();
            for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
                i64 u = indices[k];
                if (!seen[u]) {
                    seen[u] = 1;
                    nbrs.push_back(u);
                }
            }
            std::sort(nbrs.begin(), nbrs.end(), by_degree);
            for (i64 u : nbrs) queue.push_back(u);
        }
    }
    for (i64 v = 0; v < n; ++v) perm[v] = n - 1 - perm[v];
}

// Sloan profile / wavefront-minimizing ordering (Sloan 1986), scatter form
// (perm[v] = new label of v).  Per component: a pseudo-peripheral pair
// (s, e) from three breadth-first sweeps, distances to e, then a max-
// priority frontier walk with priority W2 * distance - W1 * current degree,
// a vertex's priority rising by W1 when it joins the wavefront and by W1
// for each numbered neighbour.  Status: 0 inactive, 1 preactive, 2 active,
// 3 numbered.
void sloan_order(i64 n, const i64* indptr, const i64* indices, i64* perm) {
    std::vector<i64> q;
    q.reserve(static_cast<size_t>(n));
    auto bfs_dist = [&](i64 start, std::vector<i64>& dist) -> i64 {
        std::fill(dist.begin(), dist.end(), (i64)-1);
        q.clear();
        q.push_back(start);
        dist[start] = 0;
        i64 last = start;
        for (size_t h = 0; h < q.size(); ++h) {
            i64 v = q[h];
            last = v;
            for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
                i64 u = indices[k];
                if (dist[u] < 0) {
                    dist[u] = dist[v] + 1;
                    q.push_back(u);
                }
            }
        }
        return last;
    };
    std::vector<i64> dist(static_cast<size_t>(n));
    std::vector<char> status(static_cast<size_t>(n), 0);
    std::vector<i64> pri(static_cast<size_t>(n));
    const i64 W1 = 1, W2 = 2;
    i64 rank = 0;
    for (i64 s0 = 0; s0 < n; ++s0) {
        if (status[s0] == 3) continue;
        i64 s = s0;
        i64 e = bfs_dist(s, dist);
        for (int it = 0; it < 2; ++it) {
            i64 e2 = bfs_dist(e, dist);
            s = e;
            e = e2;
        }
        bfs_dist(e, dist);  // distances to the end vertex
        for (i64 v = 0; v < n; ++v)
            if (dist[v] >= 0 && status[v] != 3)
                pri[v] = W2 * dist[v] - W1 * (indptr[v + 1] - indptr[v]);
        // lazy max-heap of (priority, vertex): an entry whose priority is
        // stale is skipped when popped
        std::priority_queue<std::pair<i64, i64>> heap;
        heap.push({pri[s], s});
        status[s] = 1;
        while (!heap.empty()) {
            i64 v = heap.top().second;
            i64 pv = heap.top().first;
            heap.pop();
            if (status[v] == 3 || pv != pri[v]) continue;
            perm[v] = rank++;
            status[v] = 3;
            for (i64 k = indptr[v]; k < indptr[v + 1]; ++k) {
                i64 u = indices[k];
                if (status[u] == 3) continue;
                if (status[u] == 0) {
                    status[u] = 1;
                    heap.push({pri[u], u});
                }
                if (status[u] == 1) {
                    status[u] = 2;
                    pri[u] += W1;
                    heap.push({pri[u], u});
                }
                pri[u] += W1;
                heap.push({pri[u], u});
            }
        }
    }
}

// Pruned pack, first call: a stable LSD radix sort of the entries by
// (tile, offset) key, kept in static buffers.  Duplicate (row, col)
// entries keep their input order, so the fill's overwrite leaves the last
// value.  Returns the step count L (every tile gets at least one step of
// `group` slots).
i64 pack_pruned_count(i64 ne, const i64* rows, const i64* cols,
                      const double* vals, i64 tile_rows, i64 group,
                      i64 reach, i64 G) {
    const u64 W = static_cast<u64>(4 * (reach + 1) + 1);
    g_pp_keys.resize(static_cast<size_t>(ne));
    g_pp_vals.resize(static_cast<size_t>(ne));
    g_pp_rloc.resize(static_cast<size_t>(ne));
    for (i64 e = 0; e < ne; ++e) {
        i64 t = rows[e] / tile_rows;
        i64 off = cols[e] - rows[e];
        g_pp_keys[e] = static_cast<u64>(t) * W + static_cast<u64>(off + reach);
        g_pp_vals[e] = vals[e];
        g_pp_rloc[e] = rows[e] - t * tile_rows;
    }
    const u64 max_key = static_cast<u64>(G) * W;
    std::vector<u64> kbuf(static_cast<size_t>(ne));
    std::vector<double> vbuf(static_cast<size_t>(ne));
    std::vector<i64> rbuf(static_cast<size_t>(ne));
    std::vector<i64> count(kBuckets);
    u64 *ks = g_pp_keys.data(), *kd = kbuf.data();
    double *vs = g_pp_vals.data(), *vd = vbuf.data();
    i64 *rs = g_pp_rloc.data(), *rd = rbuf.data();
    for (int shift = 0; shift < 64 && (max_key >> shift) != 0; shift += kRadixBits) {
        std::fill(count.begin(), count.end(), 0);
        for (i64 e = 0; e < ne; ++e) count[(ks[e] >> shift) & (kBuckets - 1)]++;
        i64 sum = 0;
        for (size_t b = 0; b < kBuckets; ++b) {
            i64 c = count[b];
            count[b] = sum;
            sum += c;
        }
        for (i64 e = 0; e < ne; ++e) {
            i64 w = count[(ks[e] >> shift) & (kBuckets - 1)]++;
            kd[w] = ks[e];
            vd[w] = vs[e];
            rd[w] = rs[e];
        }
        std::swap(ks, kd);
        std::swap(vs, vd);
        std::swap(rs, rd);
    }
    if (ks != g_pp_keys.data()) {
        std::copy_n(ks, static_cast<size_t>(ne), g_pp_keys.data());
        std::copy_n(vs, static_cast<size_t>(ne), g_pp_vals.data());
        std::copy_n(rs, static_cast<size_t>(ne), g_pp_rloc.data());
    }
    g_pp_cnt.assign(static_cast<size_t>(G), 0);
    for (i64 e = 0; e < ne; ++e) {
        if (e > 0 && g_pp_keys[e] == g_pp_keys[e - 1]) continue;
        g_pp_cnt[static_cast<size_t>(g_pp_keys[e] / W)]++;
    }
    g_pp_reach = reach;
    g_pp_G = G;
    i64 L = 0;
    for (i64 t = 0; t < G; ++t) {
        i64 steps = (g_pp_cnt[t] + group - 1) / group;
        L += steps > 0 ? steps : 1;
    }
    return L;
}

// active (tile, offset) pair count of the last pack_pruned_count call
i64 pack_pruned_active() {
    i64 s = 0;
    for (i64 c : g_pp_cnt) s += c;
    return s;
}

// Pruned pack, second call.  data: (L * group, tile_rows) values, float64
// when f64 is nonzero else float32, zeroed by the caller; offsets:
// (L * group,) signed column offset of each slot, zeroed by the caller (a
// padding slot keeps offset 0 and zero values); tile_ptr: (G + 1,) first
// slot of each tile, tile_ptr[G] = L * group.
void pack_pruned_fill(i64 ne, i64 tile_rows, i64 group, int f64, void* data,
                      i64* offsets, i64* tile_ptr) {
    const u64 W = static_cast<u64>(4 * (g_pp_reach + 1) + 1);
    float* d32 = static_cast<float*>(data);
    double* d64 = static_cast<double*>(data);
    i64 slot0 = 0, e = 0;
    for (i64 t = 0; t < g_pp_G; ++t) {
        const i64 cnt = g_pp_cnt[t];
        const i64 steps_t = cnt > 0 ? (cnt + group - 1) / group : 1;
        tile_ptr[t] = slot0;
        i64 pair = -1;
        u64 prev_key = ~0ull;
        while (e < ne && static_cast<i64>(g_pp_keys[e] / W) == t) {
            if (g_pp_keys[e] != prev_key) {
                prev_key = g_pp_keys[e];
                ++pair;
                offsets[slot0 + pair] = static_cast<i64>(g_pp_keys[e] % W) - g_pp_reach;
            }
            const i64 at = (slot0 + pair) * tile_rows + g_pp_rloc[e];
            if (f64)
                d64[at] = g_pp_vals[e];
            else
                d32[at] = static_cast<float>(g_pp_vals[e]);
            ++e;
        }
        slot0 += steps_t * group;
    }
    tile_ptr[g_pp_G] = slot0;
}

// 1-D pair-aggregation Galerkin coarsening, first call:
// C[r/2, c/2] += 0.5 * A[r, c] by a stable radix sort of the coarse keys
// and an in-order duplicate sum; exact cancellations are dropped.  Returns
// the coarse entry count.
i64 coarsen_pair_count(i64 ne, const i64* rows, const i64* cols,
                       const double* vals, i64 nc) {
    g_cp_keys.resize(static_cast<size_t>(ne));
    g_cp_vals.resize(static_cast<size_t>(ne));
    for (i64 e = 0; e < ne; ++e) {
        g_cp_keys[e] = static_cast<u64>(rows[e] / 2) * static_cast<u64>(nc) +
                       static_cast<u64>(cols[e] / 2);
        g_cp_vals[e] = 0.5 * vals[e];
    }
    const u64 max_key = static_cast<u64>(nc) * static_cast<u64>(nc);
    std::vector<u64> kbuf(static_cast<size_t>(ne));
    std::vector<double> vbuf(static_cast<size_t>(ne));
    std::vector<i64> count(kBuckets);
    u64 *ks = g_cp_keys.data(), *kd = kbuf.data();
    double *vs = g_cp_vals.data(), *vd = vbuf.data();
    for (int shift = 0; shift < 64 && (max_key >> shift) != 0; shift += kRadixBits) {
        std::fill(count.begin(), count.end(), 0);
        for (i64 e = 0; e < ne; ++e) count[(ks[e] >> shift) & (kBuckets - 1)]++;
        i64 sum = 0;
        for (size_t b = 0; b < kBuckets; ++b) {
            i64 c = count[b];
            count[b] = sum;
            sum += c;
        }
        for (i64 e = 0; e < ne; ++e) {
            i64 w = count[(ks[e] >> shift) & (kBuckets - 1)]++;
            kd[w] = ks[e];
            vd[w] = vs[e];
        }
        std::swap(ks, kd);
        std::swap(vs, vd);
    }
    // duplicate sum into the head of the static buffers (w <= e, so an
    // in-place pass reads each entry before it is overwritten)
    i64 w = -1;
    for (i64 e = 0; e < ne; ++e) {
        if (w >= 0 && ks[e] == g_cp_keys[w]) {
            g_cp_vals[w] += vs[e];
        } else {
            if (w >= 0 && g_cp_vals[w] == 0.0) --w;  // cancelled
            ++w;
            g_cp_keys[w] = ks[e];
            g_cp_vals[w] = vs[e];
        }
    }
    if (w >= 0 && g_cp_vals[w] == 0.0) --w;
    return w + 1;
}

// Pair coarsening, second call: the coarse triples of the last count call.
void coarsen_pair_fetch(i64 n_out, i64 nc, i64* out_rows, i64* out_cols,
                        double* out_vals) {
    for (i64 e = 0; e < n_out; ++e) {
        out_rows[e] = static_cast<i64>(g_cp_keys[e] / static_cast<u64>(nc));
        out_cols[e] = static_cast<i64>(g_cp_keys[e] % static_cast<u64>(nc));
        out_vals[e] = g_cp_vals[e];
    }
}

}  // extern "C"
