// Fast numeric CSV parsing + sensor-stream block packing (host runtime).
//
// The reference's data path is pandas (`dataset/tools/parser.py`), which is
// the host-side bottleneck when feeding many sequences to a TPU fleet. This
// is the native replacement: mmap'd single-pass float parsing and the
// interleaved IMU/camera block packing that would otherwise shuffle numpy
// slices in Python. Exposed to Python via ctypes; see
// msckf_tpu_torch/data/native_io.py, which builds this file with
// png_unfilter.cpp into msckf_tpu_torch/build/ at first use (g++ -O3
// -shared -fPIC). The port's copy of msckf_tpu/native/fastcsv.cpp.

#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// Parse one double starting at p; advances p. Handles +/-, decimals,
// exponents, inf/nan. Returns NAN on empty field.
inline double parse_double(const char*& p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    char* out = nullptr;
    double v = strtod(p, &out);
    if (out == p) return NAN;
    p = out;
    return v;
}

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }
};

Mapped map_file(const char* path) {
    Mapped m;
    m.fd = open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (fstat(m.fd, &st) != 0 || st.st_size == 0) {
        close(m.fd);
        m.fd = -1;
        return m;
    }
    void* ptr = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (ptr == MAP_FAILED) {
        close(m.fd);
        m.fd = -1;
        return m;
    }
    m.data = static_cast<const char*>(ptr);
    m.size = st.st_size;
    return m;
}

void unmap(Mapped& m) {
    if (m.data) munmap(const_cast<char*>(m.data), m.size);
    if (m.fd >= 0) close(m.fd);
    m.data = nullptr;
    m.fd = -1;
}

}  // namespace

extern "C" {

// Count data rows and columns of a delimited numeric file with one header
// line. Returns 0 on success.
int csv_dims(const char* path, char sep, int64_t* rows, int64_t* cols) {
    Mapped m = map_file(path);
    if (!m.ok()) return 1;
    const char* p = m.data;
    const char* end = m.data + m.size;
    // header: count columns
    int64_t c = 1;
    while (p < end && *p != '\n') {
        if (*p == sep) ++c;
        ++p;
    }
    if (p < end) ++p;  // skip newline
    int64_t r = 0;
    while (p < end) {
        const char* line_start = p;
        while (p < end && *p != '\n') ++p;
        if (p > line_start) ++r;  // non-empty line
        if (p < end) ++p;
    }
    *rows = r;
    *cols = c;
    unmap(m);
    return 0;
}

// Parse the numeric body (after one header line) into out (rows*cols,
// row-major). Non-numeric fields become NaN. Returns number of rows parsed,
// or -1 on error.
int64_t csv_read(const char* path, char sep, double* out, int64_t rows, int64_t cols) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    const char* p = m.data;
    const char* end = m.data + m.size;
    while (p < end && *p != '\n') ++p;  // skip header
    if (p < end) ++p;
    int64_t r = 0;
    while (p < end && r < rows) {
        const char* line_start = p;
        const char* line_end = p;
        while (line_end < end && *line_end != '\n') ++line_end;
        if (line_end > line_start) {
            const char* q = line_start;
            for (int64_t c = 0; c < cols; ++c) {
                out[r * cols + c] = parse_double(q, line_end);
                while (q < line_end && *q != sep) ++q;
                if (q < line_end) ++q;  // skip separator
            }
            ++r;
        }
        p = (line_end < end) ? line_end + 1 : end;
    }
    unmap(m);
    return r;
}

// Pack IMU ticks into camera-frame blocks (the layout msckf_tpu's scan
// consumes): block j spans ticks [cam_ticks[j], cam_ticks[j+1]) with
// out-of-range slots zero and valid=0. All outputs are preallocated by the
// caller: ts/gyro/acc (C*B[,3]) doubles, valid (C*B) uint8.
int pack_blocks(const double* imu_ts, const double* gyro, const double* acc,
                int64_t n_ticks, const int64_t* cam_ticks, int64_t n_frames,
                int64_t block, double* out_ts, double* out_gyro,
                double* out_acc, uint8_t* out_valid) {
    for (int64_t j = 0; j < n_frames; ++j) {
        int64_t a = cam_ticks[j];
        int64_t b = (j + 1 < n_frames) ? cam_ticks[j + 1] : n_ticks;
        if (a < 0 || b > n_ticks || b < a || (b - a) > block) return 1;
        for (int64_t i = 0; i < block; ++i) {
            int64_t dst = j * block + i;
            if (a + i < b) {
                out_ts[dst] = imu_ts[a + i];
                for (int k = 0; k < 3; ++k) {
                    out_gyro[dst * 3 + k] = gyro[(a + i) * 3 + k];
                    out_acc[dst * 3 + k] = acc[(a + i) * 3 + k];
                }
                out_valid[dst] = 1;
            } else {
                out_ts[dst] = 0.0;
                for (int k = 0; k < 3; ++k) {
                    out_gyro[dst * 3 + k] = 0.0;
                    out_acc[dst * 3 + k] = 0.0;
                }
                out_valid[dst] = 0;
            }
        }
    }
    return 0;
}

// Threaded multi-file loader: parse n_files numeric CSVs concurrently, each
// into its caller-preallocated buffer (the multi-sequence feeder for the
// batched runner — python-side pandas loads serialize on the GIL). A small
// pool of std::threads drains an atomic work index; each worker runs the
// same mmap single-pass parser as csv_read. Returns 0 iff every file parsed
// exactly its expected row count.
int csv_read_many(const char** paths, char sep, double** outs,
                  const int64_t* rows, const int64_t* cols, int64_t n_files,
                  int64_t n_threads) {
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n_files) n_threads = n_files;
    std::atomic<int64_t> next(0);
    std::atomic<int> failures(0);
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_files) return;
            int64_t got = csv_read(paths[i], sep, outs[i], rows[i], cols[i]);
            if (got != rows[i]) failures.fetch_add(1);
        }
    };
    std::vector<std::thread> pool;
    for (int64_t t = 1; t < n_threads; ++t) pool.emplace_back(worker);
    worker();
    for (auto& th : pool) th.join();
    return failures.load() == 0 ? 0 : 1;
}

}  // extern "C"
