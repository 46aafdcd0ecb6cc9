// libpcol: native data plane for the PCOL columnar file format (the
// PyTorch port's own copy of presto_tpu/native/pcol.cpp).
//
// Column chunks are raw little-endian arrays, 64-byte aligned, mmap-ed and
// handed to numpy zero-copy, so a read is page cache -> host array with no
// decode step. The C++ side owns:
//   - mmap lifecycle (open/close, shared read-only mappings)
//   - write-time column statistics (min/max over int64/int32/float64 chunks)
//   - range pre-filters (selection masks), which the file connector's scan
//     runs on pushed-down ranges before rows are uploaded.
//
// Built at first use by presto_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -std=c++17 pcol.cpp -o build/libpcol.so

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct PcolMap {
    void* addr;
    uint64_t length;
    int fd;
};

// Open + mmap a pcol file read-only. Returns nullptr on failure.
PcolMap* pcol_open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
    void* addr = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    if (addr == MAP_FAILED) { ::close(fd); return nullptr; }
    // sequential scan hint: the kernel readahead does the prefetching the
    // reference implements with its async IO executor
    madvise(addr, (size_t)st.st_size, MADV_SEQUENTIAL);
    auto* m = new PcolMap{addr, (uint64_t)st.st_size, fd};
    return m;
}

uint64_t pcol_length(PcolMap* m) { return m ? m->length : 0; }

// Base pointer of the mapping (Python slices columns out of it zero-copy).
const uint8_t* pcol_data(PcolMap* m) {
    return m ? (const uint8_t*)m->addr : nullptr;
}

void pcol_close(PcolMap* m) {
    if (!m) return;
    munmap(m->addr, m->length);
    ::close(m->fd);
    delete m;
}

// ---------------------------------------------------------------- statistics

// min/max over an int64 column chunk (write-time stats + split pruning).
void pcol_stats_i64(const int64_t* data, uint64_t n, int64_t* out_min,
                    int64_t* out_max) {
    int64_t mn = INT64_MAX, mx = INT64_MIN;
    for (uint64_t i = 0; i < n; i++) {
        int64_t v = data[i];
        mn = v < mn ? v : mn;
        mx = v > mx ? v : mx;
    }
    *out_min = mn;
    *out_max = mx;
}

void pcol_stats_f64(const double* data, uint64_t n, double* out_min,
                    double* out_max) {
    double mn = 1.0 / 0.0, mx = -1.0 / 0.0;
    for (uint64_t i = 0; i < n; i++) {
        double v = data[i];
        mn = v < mn ? v : mn;
        mx = v > mx ? v : mx;
    }
    *out_min = mn;
    *out_max = mx;
}

void pcol_stats_i32(const int32_t* data, uint64_t n, int64_t* out_min,
                    int64_t* out_max) {
    int64_t mn = INT64_MAX, mx = INT64_MIN;
    for (uint64_t i = 0; i < n; i++) {
        int64_t v = data[i];
        mn = v < mn ? v : mn;
        mx = v > mx ? v : mx;
    }
    *out_min = mn;
    *out_max = mx;
}

// ---------------------------------------------------------- range filtering

// mask[i] &= lo <= data[i] <= hi. Returns the selected count.
uint64_t pcol_filter_range_i64(const int64_t* data, uint64_t n, int64_t lo,
                               int64_t hi, uint8_t* mask) {
    uint64_t count = 0;
    for (uint64_t i = 0; i < n; i++) {
        uint8_t keep = (data[i] >= lo) & (data[i] <= hi);
        mask[i] &= keep;  // AND into the caller's running mask
        count += mask[i];
    }
    return count;
}

uint64_t pcol_filter_range_i32(const int32_t* data, uint64_t n, int64_t lo,
                               int64_t hi, uint8_t* mask) {
    uint64_t count = 0;
    for (uint64_t i = 0; i < n; i++) {
        uint8_t keep = (data[i] >= lo) & (data[i] <= hi);
        mask[i] &= keep;
        count += mask[i];
    }
    return count;
}

}  // extern "C"
