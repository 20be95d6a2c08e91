// Native threaded block reader/writer for ChASE-format (column-major)
// binary matrix files.
//
// The PyTorch port's copy of chase_tpu/_native/chaseio.cpp (the port
// builds and loads its own, chase_tpu_torch/_native/__init__.py), the
// counterpart of the reference's MPI-IO subarray machinery
// (linalg/distMatrix/distMatrix.hpp:2243-2410: MPI_File_set_view +
// MPI_File_read_all of a 2D-distributed sub-block): a caller pulls only
// the bytes of its own block.  numpy memmap fancy-slicing of a
// column-major file issues one small strided read per row; this reader
// instead streams whole columns with pread(2) across a thread pool with the
// GIL released (ctypes releases it for us), which is the difference between
// page-cache speed and syscall-bound loading for the multi-GB matrices of
// the N=30k-76k target configs.
//
// Layout contract: the file stores a rows_total x cols_total matrix
// column-major (ChASE Matrix::saveToBinaryFile).  chase_read_block copies
// the sub-block [row_start, row_start+row_count) x [col_start,
// col_start+col_count) into `out`, also column-major (leading dimension
// row_count).  chase_read_gather copies the rows and columns named by two
// index lists (a block-cyclic owner's, MPI_Type_create_darray's view in
// the reference, distMatrix.hpp:3210-3260): one pread of each listed
// column's row span [min row, max row], the listed rows kept in runs —
// one call and one read per column, where a read per contiguous run
// would be a read of mb elements each.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Plan {
    int fd;
    int64_t rows_total;
    int64_t itemsize;
    int64_t row_start, row_count;
    int64_t col_start, col_count;
    char* out;
};

// Read one file column's sub-range into the output column.
inline int read_col(const Plan& p, int64_t j) {
    const int64_t file_col = p.col_start + j;
    const int64_t off =
        (file_col * p.rows_total + p.row_start) * p.itemsize;
    char* dst = p.out + j * p.row_count * p.itemsize;
    int64_t want = p.row_count * p.itemsize;
    int64_t done = 0;
    while (done < want) {
        ssize_t r = pread(p.fd, dst + done, want - done, off + done);
        if (r < 0) {
            if (errno == EINTR) continue;
            return errno ? errno : -1;
        }
        if (r == 0) return -2;  // premature EOF
        done += r;
    }
    return 0;
}

// pread exactly `want` bytes at `off`; 0, errno, or -2 at a premature EOF.
inline int pread_all(int fd, char* dst, int64_t want, int64_t off) {
    int64_t done = 0;
    while (done < want) {
        ssize_t r = pread(fd, dst + done, want - done, off + done);
        if (r < 0) {
            if (errno == EINTR) continue;
            return errno ? errno : -1;
        }
        if (r == 0) return -2;
        done += r;
    }
    return 0;
}

// Run `work(j)` for j in [0, count) on up to `nthreads` threads, each
// with its own scratch buffer of `scratch` bytes; the first error wins.
template <class Work>
int parallel_columns(int64_t count, int nthreads, int64_t scratch,
                     Work work) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > count) nthreads = static_cast<int>(count);
    std::atomic<int64_t> next{0};
    std::atomic<int> err{0};
    auto worker = [&]() {
        std::vector<char> buf(scratch);
        for (;;) {
            int64_t j = next.fetch_add(1);
            if (j >= count || err.load()) break;
            int e = work(j, buf.data());
            if (e) err.store(e);
        }
    };
    if (nthreads <= 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        ts.reserve(nthreads);
        for (int t = 0; t < nthreads; ++t) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
    return err.load();
}

}  // namespace

extern "C" {

// Returns 0 on success, a positive errno or negative internal code on error.
int chase_read_block(const char* path, int64_t rows_total, int64_t itemsize,
                     int64_t row_start, int64_t row_count, int64_t col_start,
                     int64_t col_count, void* out, int nthreads) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return errno;
    Plan p{fd, rows_total, itemsize, row_start, row_count,
           col_start, col_count, static_cast<char*>(out)};

    if (nthreads < 1) nthreads = 1;
    if (nthreads > col_count) nthreads = static_cast<int>(col_count);

    std::atomic<int64_t> next{0};
    std::atomic<int> err{0};
    auto worker = [&]() {
        for (;;) {
            int64_t j = next.fetch_add(1);
            if (j >= p.col_count || err.load()) break;
            int e = read_col(p, j);
            if (e) err.store(e);
        }
    };
    if (nthreads == 1) {
        worker();
    } else {
        std::vector<std::thread> ts;
        ts.reserve(nthreads);
        for (int t = 0; t < nthreads; ++t) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
    }
    close(fd);
    return err.load();
}

// Gather rows[0..row_count) x cols[0..col_count) (global indices) of the
// file into `out`, column-major with leading dimension row_count.  Each
// column's span [min(rows), max(rows)] is read with one pread into a
// per-thread buffer and the rows copied out in their contiguous runs.
// Returns 0, a positive errno or a negative internal code.
int chase_read_gather(const char* path, int64_t rows_total,
                      int64_t itemsize, const int64_t* rows,
                      int64_t row_count, const int64_t* cols,
                      int64_t col_count, void* out, int nthreads) {
    if (row_count == 0 || col_count == 0) return 0;
    const int64_t rmin = *std::min_element(rows, rows + row_count);
    const int64_t rmax = *std::max_element(rows, rows + row_count);
    if (rmin < 0 || rmax >= rows_total) return -3;
    // runs of consecutive rows: (first row - rmin, count, output offset)
    std::vector<int64_t> runs;
    for (int64_t i = 0; i < row_count;) {
        int64_t e = i + 1;
        while (e < row_count && rows[e] == rows[e - 1] + 1) ++e;
        runs.insert(runs.end(), {rows[i] - rmin, e - i, i});
        i = e;
    }
    int fd = open(path, O_RDONLY);
    if (fd < 0) return errno;
    char* dst = static_cast<char*>(out);
    const int64_t span = (rmax - rmin + 1) * itemsize;
    int err = parallel_columns(
        col_count, nthreads, span, [&](int64_t j, char* buf) {
            const int64_t off = (cols[j] * rows_total + rmin) * itemsize;
            int e = pread_all(fd, buf, span, off);
            if (e) return e;
            char* col = dst + j * row_count * itemsize;
            for (size_t q = 0; q < runs.size(); q += 3)
                std::memcpy(col + runs[q + 2] * itemsize,
                            buf + runs[q] * itemsize, runs[q + 1] * itemsize);
            return 0;
        });
    close(fd);
    return err;
}

// Write a column-major sub-block into (a possibly pre-sized) file.
int chase_write_block(const char* path, int64_t rows_total, int64_t itemsize,
                      int64_t row_start, int64_t row_count, int64_t col_start,
                      int64_t col_count, const void* data) {
    int fd = open(path, O_WRONLY | O_CREAT, 0644);
    if (fd < 0) return errno;
    const char* src = static_cast<const char*>(data);
    for (int64_t j = 0; j < col_count; ++j) {
        const int64_t file_col = col_start + j;
        const int64_t off =
            (file_col * rows_total + row_start) * itemsize;
        const char* s = src + j * row_count * itemsize;
        int64_t want = row_count * itemsize;
        int64_t done = 0;
        while (done < want) {
            ssize_t w = pwrite(fd, s + done, want - done, off + done);
            if (w < 0) {
                if (errno == EINTR) continue;
                int e = errno;
                close(fd);
                return e;
            }
            done += w;
        }
    }
    close(fd);
    return 0;
}

}  // extern "C"
