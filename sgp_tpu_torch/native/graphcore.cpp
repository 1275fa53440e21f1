// Host-side graph kernels of sgp_tpu_torch: edge coalescing, the k-hop BFS
// over a CSR, a CSR SpMM (a host oracle) and a uniform edge subsample.
//
// The port's own copy of sgp_tpu/native/graphcore.cpp, function for
// function, so that the port's coalesce and k_hop_subgraph give the JAX
// package's results bit for bit on the same route. Host code: nothing here
// runs on the card. A plain C interface, loaded with ctypes by
// sgp_tpu_torch/native/__init__.py, which builds it as
//
//   g++ -O3 -shared -fPIC -o build/graphcore_<hash>.so graphcore.cpp
//
// (no -march=native: with it GCC contracts csr_spmm's o[c] += wv * xr[c]
// into an FMA and the bits differ from the JAX package's build).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Sort edges by (dst, src) and merge duplicates (weights summed).
// Returns the new edge count. Output arrays must have capacity e.
int64_t coalesce_edges(const int32_t* src, const int32_t* dst,
                       const float* w, int64_t e, int64_t n,
                       int32_t* out_src, int32_t* out_dst, float* out_w) {
    std::vector<int64_t> order(e);
    std::iota(order.begin(), order.end(), 0);
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        if (dst[a] != dst[b]) return dst[a] < dst[b];
        return src[a] < src[b];
    });
    int64_t m = 0;
    for (int64_t idx = 0; idx < e; ++idx) {
        int64_t i = order[idx];
        if (m > 0 && out_src[m - 1] == src[i] && out_dst[m - 1] == dst[i]) {
            out_w[m - 1] += w[i];
        } else {
            out_src[m] = src[i];
            out_dst[m] = dst[i];
            out_w[m] = w[i];
            ++m;
        }
    }
    return m;
}

// Build CSR (rows = dst) from coalesced COO sorted by (dst, src).
void build_csr(const int32_t* dst, int64_t e, int64_t n,
               int64_t* indptr) {
    std::memset(indptr, 0, sizeof(int64_t) * (n + 1));
    for (int64_t i = 0; i < e; ++i) indptr[dst[i] + 1]++;
    for (int64_t r = 0; r < n; ++r) indptr[r + 1] += indptr[r];
}

// K-hop BFS from roots following CSR rows (row r lists the *sources*
// feeding node r — flow 'target_to_source'). Writes 1 into out_mask for
// every reached node (roots included). Returns number of reached nodes.
int64_t khop_bfs(const int64_t* indptr, const int32_t* indices, int64_t n,
                 const int32_t* roots, int64_t n_roots, int64_t k,
                 uint8_t* out_mask) {
    std::memset(out_mask, 0, n);
    std::vector<int32_t> frontier(roots, roots + n_roots);
    for (int64_t i = 0; i < n_roots; ++i) out_mask[roots[i]] = 1;
    int64_t count = n_roots;
    for (int64_t hop = 0; hop < k && !frontier.empty(); ++hop) {
        std::vector<int32_t> next;
        for (int32_t t : frontier) {
            for (int64_t j = indptr[t]; j < indptr[t + 1]; ++j) {
                int32_t s = indices[j];
                if (!out_mask[s]) {
                    out_mask[s] = 1;
                    next.push_back(s);
                    ++count;
                }
            }
        }
        frontier.swap(next);
    }
    return count;
}

// CSR SpMM: out[r, :] = sum_j data[j] * x[indices[j], :] for j in row r.
// Host-side oracle / preprocessing path.
void csr_spmm(const int64_t* indptr, const int32_t* indices,
              const float* data, const float* x, int64_t n, int64_t f,
              float* out) {
    for (int64_t r = 0; r < n; ++r) {
        float* o = out + r * f;
        std::memset(o, 0, sizeof(float) * f);
        for (int64_t j = indptr[r]; j < indptr[r + 1]; ++j) {
            const float wv = data[j];
            const float* xr = x + static_cast<int64_t>(indices[j]) * f;
            for (int64_t c = 0; c < f; ++c) o[c] += wv * xr[c];
        }
    }
}

// Deterministic uniform edge subsample without replacement
// (Fisher-Yates prefix on an xorshift PRNG). Writes m indices.
void sample_edges_uniform(int64_t e, int64_t m, uint64_t seed,
                          int64_t* out_idx) {
    std::vector<int64_t> pool(e);
    std::iota(pool.begin(), pool.end(), 0);
    uint64_t s = seed ? seed : 0x9E3779B97F4A7C15ull;
    auto next = [&]() {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17; return s;
    };
    for (int64_t i = 0; i < m && i < e; ++i) {
        int64_t j = i + static_cast<int64_t>(next() % (e - i));
        std::swap(pool[i], pool[j]);
        out_idx[i] = pool[i];
    }
}

}  // extern "C"
