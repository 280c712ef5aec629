// Copied from pointcloudpdf_tpu/native/csrc/voxel_hash.cpp; keep in step.
// Host-side voxelization core for the data pipeline.
//
// The reference's GridSample transform (pointcept/datasets/transform.py:
// 788-925) spends its time in np.argsort + np.unique over FNV voxel keys
// — O(N log N) comparison sorting per sample on the CPU.  This native
// core replaces it with a single-pass open-addressing hash table
// (O(N)), producing the same (sorted-by-first-occurrence) artifacts the
// transform needs: per-voxel counts, each point's voxel id, and point
// indices grouped by voxel.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct HashTable {
    std::vector<uint64_t> keys;
    std::vector<int64_t> vals;
    uint64_t mask;

    explicit HashTable(int64_t n) {
        uint64_t cap = 1;
        while (cap < static_cast<uint64_t>(n) * 2) cap <<= 1;
        keys.assign(cap, UINT64_MAX);
        vals.assign(cap, -1);
        mask = cap - 1;
    }

    // returns slot's value, inserting `next_id` if absent (-1 sentinel key
    // space is avoided by callers hashing real keys only)
    int64_t get_or_insert(uint64_t key, int64_t next_id, bool* inserted) {
        uint64_t h = key * 0x9E3779B97F4A7C15ULL;
        uint64_t i = h & mask;
        while (true) {
            if (keys[i] == key) { *inserted = false; return vals[i]; }
            if (keys[i] == UINT64_MAX) {
                keys[i] = key;
                vals[i] = next_id;
                *inserted = true;
                return next_id;
            }
            i = (i + 1) & mask;
        }
    }
};

}  // namespace

extern "C" {

// keys (n), outputs: inverse (n) voxel id per point in first-occurrence
// order, counts (n, first num_unique valid), order (n): point indices
// grouped by voxel (voxel 0's points first), starts (n+1): CSR offsets
// into order.  Returns num_unique.
int64_t voxel_unique(const uint64_t* keys, int64_t n, int64_t* inverse,
                     int64_t* counts, int64_t* order, int64_t* starts) {
    if (n == 0) { starts[0] = 0; return 0; }
    HashTable table(n);
    int64_t num_unique = 0;
    for (int64_t i = 0; i < n; ++i) {
        bool inserted = false;
        int64_t id = table.get_or_insert(keys[i], num_unique, &inserted);
        if (inserted) { counts[num_unique] = 0; ++num_unique; }
        inverse[i] = id;
        ++counts[id];
    }
    starts[0] = 0;
    for (int64_t v = 0; v < num_unique; ++v) starts[v + 1] = starts[v] + counts[v];
    std::vector<int64_t> cursor(starts, starts + num_unique);
    for (int64_t i = 0; i < n; ++i) order[cursor[inverse[i]]++] = i;
    return num_unique;
}

// 64-bit FNV hash of integer voxel coordinates, bit-identical to
// transform.fnv_hash_vec (FNV-1 order: multiply then xor, and each int32
// coordinate widens through uint64 like numpy's uint64 cast)
void fnv_hash_rows(const int32_t* grid, int64_t n, uint64_t* out) {
    const uint64_t kBasis = 14695981039346656037ULL;
    const uint64_t kPrime = 1099511628211ULL;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h = kBasis;
        for (int64_t d = 0; d < 3; ++d) {
            h *= kPrime;
            h ^= static_cast<uint64_t>(
                static_cast<int64_t>(grid[i * 3 + d]));
        }
        out[i] = h;
    }
}

}  // extern "C"
