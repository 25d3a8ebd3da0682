// Exact-grouping primitives for the host schedule of the deduplicated
// batch verify (cuzk_tpu_torch/merkle.py, _dedup_schedule/_dedup_pack).
//
// The schedule partitions proof rows by EXACT byte equality: level-0
// content groups, per-level sibling rows, suffix triples and the value
// table.  An open-addressing hash table keyed by the FULL row bytes (or
// triple) does each partition: every probe compares contents, never
// trusts a hash, so no crafted collision can merge two distinct rows.
// Group ids are first-occurrence ranks, so the output is deterministic and
// equal to cuzk_tpu/native/scheduler.cpp's for the same rows; this file is
// a copy of that one's two routines.
//
// Built at first use with g++ -O3 (cuzk_tpu_torch/native/__init__.py) and
// called through ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline uint64_t mix64(uint64_t x) {
    x ^= x >> 33;
    x *= 0xff51afd7ed558ccdULL;
    x ^= x >> 33;
    x *= 0xc4ceb9fe1a85ec53ULL;
    x ^= x >> 33;
    return x;
}

inline uint64_t load64(const uint8_t* p) {
    uint64_t w;
    std::memcpy(&w, p, 8);  // unaligned-safe; compiles to one movq on x86
    return w;
}

inline int64_t table_capacity(int64_t k) {
    int64_t cap = 16;
    while (cap < 2 * k) cap <<= 1;
    return cap;
}

}  // namespace

extern "C" {

// Partition k rows (wbytes each, row i at rows + i*stride; wbytes must be
// a multiple of 8) by exact byte equality.  out_first[g] = index of group
// g's first-occurring row (capacity k); out_inv[i] = group id of row i.
// Returns the number of groups.
int64_t cuzk_group_rows(const uint8_t* rows, int64_t k, int64_t stride,
                        int64_t wbytes, int32_t* out_first,
                        int32_t* out_inv) {
    const int64_t cap = table_capacity(k);
    const uint64_t mask = (uint64_t)(cap - 1);
    std::vector<int64_t> slot(cap, -1);  // representative row index
    const int64_t nw = wbytes / 8;
    int64_t u = 0;
    for (int64_t i = 0; i < k; ++i) {
        const uint8_t* r = rows + i * stride;
        // One multiply per word, avalanched once at the end: the hash only
        // PLACES rows in the table; every probe byte-compares.
        uint64_t h = 0x9e3779b97f4a7c15ULL;
        for (int64_t j = 0; j < nw; ++j)
            h = (h ^ load64(r + 8 * j)) * 0x9e3779b97f4a7c15ULL;
        uint64_t p = mix64(h) & mask;
        for (;;) {
            const int64_t s = slot[p];
            if (s < 0) {
                slot[p] = i;
                out_first[u] = (int32_t)i;
                out_inv[i] = (int32_t)u;
                ++u;
                break;
            }
            if (std::memcmp(r, rows + s * stride, (size_t)wbytes) == 0) {
                out_inv[i] = out_inv[s];
                break;
            }
            p = (p + 1) & mask;
        }
    }
    return u;
}

// Partition k (a, b, c) int32 triples by exact equality (the suffix key
// (parent-suffix group, sibling-row group, position)).  Same outputs as
// cuzk_group_rows; no bit-packing, so it works for any k.
int64_t cuzk_group_triples(const int32_t* a, const int32_t* b,
                           const int32_t* c, int64_t k, int32_t* out_first,
                           int32_t* out_inv) {
    const int64_t cap = table_capacity(k);
    const uint64_t mask = (uint64_t)(cap - 1);
    std::vector<int64_t> slot(cap, -1);
    int64_t u = 0;
    for (int64_t i = 0; i < k; ++i) {
        uint64_t h = mix64(((uint64_t)(uint32_t)a[i] << 32) ^
                           (uint32_t)b[i]);
        h = mix64(h ^ (uint32_t)c[i]);
        uint64_t p = h & mask;
        for (;;) {
            const int64_t s = slot[p];
            if (s < 0) {
                slot[p] = i;
                out_first[u] = (int32_t)i;
                out_inv[i] = (int32_t)u;
                ++u;
                break;
            }
            if (a[s] == a[i] && b[s] == b[i] && c[s] == c[i]) {
                out_inv[i] = out_inv[s];
                break;
            }
            p = (p + 1) & mask;
        }
    }
    return u;
}

}  // extern "C"
