// Fast BAL dataset parser + problem preprocessor (native runtime component).
//
// Role parity: the reference's problem-construction/preprocessing path is
// C++ (examples/bal_problem.cc loader; internal/ceres preprocessor) and its
// README flags preprocessor time as a real cost (37-47 s on BAL-13682,
// README.md:152,186). A Python text parser at that scale is minutes; this
// component memory-maps the file, parses with std::from_chars, and also
// provides the sort-by-camera permutation used to lay residual blocks out
// gather/segment-sum friendly (SURVEY.md §7 "sorted-by-camera layouts").
//
// C ABI, consumed from Python via ctypes (ceres_tpu_torch/io/native.py, which
// builds this file with g++ at first use: cuda_lib.build_host). The same
// functions and signatures as the JAX package's native/bal_loader.cc.

#include <algorithm>
#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Cursor {
  const char* p;
  const char* end;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) ++p;
  }

  bool next_i64(int64_t* out) {
    skip_ws();
    if (p >= end) return false;
    auto [next, ec] = std::from_chars(p, end, *out);
    if (ec != std::errc()) return false;
    p = next;
    return true;
  }

  bool next_f64(double* out) {
    skip_ws();
    if (p >= end) return false;
    auto [next, ec] = std::from_chars(p, end, *out);
    if (ec != std::errc()) return false;
    p = next;
    return true;
  }
};

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = static_cast<size_t>(st.st_size);
    data = static_cast<const char*>(mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0));
    return data != MAP_FAILED;
  }

  ~Mapped() {
    if (data && data != MAP_FAILED) munmap(const_cast<char*>(data), size);
    if (fd >= 0) close(fd);
  }
};

}  // namespace

extern "C" {

// Reads only the header: returns 0 on success.
int bal_header(const char* path, int64_t* num_cameras, int64_t* num_points,
               int64_t* num_observations) {
  Mapped m;
  if (!m.open(path)) return -1;
  Cursor c{m.data, m.data + m.size};
  if (!c.next_i64(num_cameras) || !c.next_i64(num_points) ||
      !c.next_i64(num_observations))
    return -2;
  return 0;
}

// Parses the full file into caller-allocated buffers:
//   camera_index [num_obs], point_index [num_obs] (int64)
//   observations [num_obs * 2], cameras [num_cameras * 9],
//   points [num_points * 3] (double)
// Returns 0 on success, negative on parse error.
int bal_load(const char* path, int64_t* camera_index, int64_t* point_index,
             double* observations, double* cameras, double* points) {
  Mapped m;
  if (!m.open(path)) return -1;
  Cursor c{m.data, m.data + m.size};
  int64_t nc, np, no;
  if (!c.next_i64(&nc) || !c.next_i64(&np) || !c.next_i64(&no)) return -2;
  for (int64_t i = 0; i < no; ++i) {
    if (!c.next_i64(&camera_index[i]) || !c.next_i64(&point_index[i]) ||
        !c.next_f64(&observations[2 * i]) || !c.next_f64(&observations[2 * i + 1]))
      return -3;
  }
  const int64_t ncam_vals = nc * 9;
  for (int64_t i = 0; i < ncam_vals; ++i)
    if (!c.next_f64(&cameras[i])) return -4;
  const int64_t npt_vals = np * 3;
  for (int64_t i = 0; i < npt_vals; ++i)
    if (!c.next_f64(&points[i])) return -5;
  return 0;
}

// Stable sort permutation of observations by (camera, point): the layout
// that makes per-camera segment sums contiguous. perm must hold num_obs.
void sort_by_camera(const int64_t* camera_index, const int64_t* point_index,
                    int64_t num_obs, int64_t* perm) {
  std::iota(perm, perm + num_obs, int64_t{0});
  std::stable_sort(perm, perm + num_obs, [&](int64_t a, int64_t b) {
    if (camera_index[a] != camera_index[b])
      return camera_index[a] < camera_index[b];
    return point_index[a] < point_index[b];
  });
}

// Degree counts (observations per camera / per point) — the inputs of the
// greedy Schur e/f partition. Buffers must be zero-initialized by caller.
void count_degrees(const int64_t* camera_index, const int64_t* point_index,
                   int64_t num_obs, int64_t* camera_degree,
                   int64_t* point_degree) {
  for (int64_t i = 0; i < num_obs; ++i) {
    ++camera_degree[camera_index[i]];
    ++point_degree[point_index[i]];
  }
}

// COO -> CRS row pointers + column-sorted permutation for Jacobian export.
// rows/cols are the COO coordinates; perm gets the lexicographic (row, col)
// order; row_ptr must hold num_rows + 1 and be zero-initialized.
void coo_to_crs(const int64_t* rows, const int64_t* cols, int64_t nnz,
                int64_t num_rows, int64_t* perm, int64_t* row_ptr) {
  std::iota(perm, perm + nnz, int64_t{0});
  std::stable_sort(perm, perm + nnz, [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });
  for (int64_t i = 0; i < nnz; ++i) ++row_ptr[rows[i] + 1];
  for (int64_t r = 0; r < num_rows; ++r) row_ptr[r + 1] += row_ptr[r];
}

}  // extern "C"
