// wavelets_tpu native runtime: frame-stack IO.
//
// Host-side data path for production serving: frame stacks (detector
// dumps, image sequences) are memory-mapped and converted into the
// float32 staging buffers that feed the device, with multi-threaded
// dtype conversion and endian swapping done in native code instead of
// GIL-bound Python loops.  Exposed as a plain C ABI consumed via ctypes
// (wavelets_tpu/utils/frameio.py).
//
// The reference package has no IO layer at all (SURVEY §2: watroo is a
// pure in-memory library); this is part of the runtime the accelerator
// framework adds around the compute core.
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Handle {
  int fd = -1;
  void* map = nullptr;
  int64_t map_bytes = 0;
  int64_t offset = 0;       // header bytes to skip
  int64_t frame_bytes = 0;  // stored bytes per frame
  int64_t n_frames = 0;
};

enum DType : int {
  U8 = 0,
  U16 = 1,
  I16 = 2,
  U32 = 3,
  I32 = 4,
  F32 = 5,
  F64 = 6,
  U16BE = 7,
  F32BE = 8,
};

inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }

template <typename Fn>
void parallel_for(int64_t n, int nthreads, Fn fn) {
  if (nthreads <= 1 || n < (1 << 16)) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    ts.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

// convert n elements from src (dtype dt) to float32 dst
int convert_f32(const void* src, float* dst, int dt, int64_t n,
                int nthreads) {
  switch (dt) {
    case U8: {
      auto* s = static_cast<const uint8_t*>(src);
      parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) dst[i] = float(s[i]);
      });
      return 0;
    }
    case U16: {
      auto* s = static_cast<const uint16_t*>(src);
      parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) dst[i] = float(s[i]);
      });
      return 0;
    }
    case I16: {
      auto* s = static_cast<const int16_t*>(src);
      parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) dst[i] = float(s[i]);
      });
      return 0;
    }
    case U32: {
      auto* s = static_cast<const uint32_t*>(src);
      parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) dst[i] = float(s[i]);
      });
      return 0;
    }
    case I32: {
      auto* s = static_cast<const int32_t*>(src);
      parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) dst[i] = float(s[i]);
      });
      return 0;
    }
    case F32: {
      parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
        memcpy(dst + lo, static_cast<const float*>(src) + lo,
               size_t(hi - lo) * 4);
      });
      return 0;
    }
    case F64: {
      auto* s = static_cast<const double*>(src);
      parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) dst[i] = float(s[i]);
      });
      return 0;
    }
    case U16BE: {
      auto* s = static_cast<const uint16_t*>(src);
      parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) dst[i] = float(bswap16(s[i]));
      });
      return 0;
    }
    case F32BE: {
      auto* s = static_cast<const uint32_t*>(src);
      parallel_for(n, nthreads, [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
          uint32_t v = bswap32(s[i]);
          float f;
          memcpy(&f, &v, 4);
          dst[i] = f;
        }
      });
      return 0;
    }
  }
  return -1;
}

}  // namespace

extern "C" {

void* wtio_open(const char* path, int64_t offset, int64_t frame_bytes,
                int64_t n_frames) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  // Reject sizes that are non-positive or whose product/sum would
  // overflow int64 (a wrapped-negative `need` would pass the st_size
  // check and let frame reads run past the mmap bounds).
  int64_t need = 0, total = 0;
  if (offset < 0 || frame_bytes <= 0 || n_frames <= 0 ||
      __builtin_mul_overflow(frame_bytes, n_frames, &total) ||
      __builtin_add_overflow(offset, total, &need) ||
      st.st_size < need) {
    ::close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, size_t(st.st_size), PROT_READ, MAP_SHARED,
                   fd, 0);
  if (map == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  madvise(map, size_t(st.st_size), MADV_SEQUENTIAL);
  auto* h = new Handle;
  h->fd = fd;
  h->map = map;
  h->map_bytes = st.st_size;
  h->offset = offset;
  h->frame_bytes = frame_bytes;
  h->n_frames = n_frames;
  return h;
}

int64_t wtio_n_frames(void* hv) {
  return static_cast<Handle*>(hv)->n_frames;
}

// Hint the OS to page in a frame ahead of use.
void wtio_prefetch(void* hv, int64_t idx) {
  auto* h = static_cast<Handle*>(hv);
  if (idx < 0 || idx >= h->n_frames) return;
  char* p = static_cast<char*>(h->map) + h->offset +
            idx * h->frame_bytes;
  madvise(p, size_t(h->frame_bytes), MADV_WILLNEED);
}

// Read frame `idx`, converting `n_elems` elements of dtype `dt` to f32.
int wtio_read_frame_f32(void* hv, int64_t idx, int dt, float* dst,
                        int64_t n_elems, int nthreads) {
  auto* h = static_cast<Handle*>(hv);
  if (idx < 0 || idx >= h->n_frames) return -2;
  const char* p = static_cast<const char*>(h->map) + h->offset +
                  idx * h->frame_bytes;
  return convert_f32(p, dst, dt, n_elems, nthreads);
}

// Batched read: frames listed in `indices` into a contiguous f32 buffer.
int wtio_read_batch_f32(void* hv, const int64_t* indices, int64_t count,
                        int dt, float* dst, int64_t n_elems,
                        int nthreads) {
  auto* h = static_cast<Handle*>(hv);
  for (int64_t i = 0; i < count; ++i) {
    if (i + 1 < count) wtio_prefetch(hv, indices[i + 1]);
    int rc = wtio_read_frame_f32(hv, indices[i], dt,
                                 dst + i * n_elems, n_elems, nthreads);
    if (rc != 0) return rc;
  }
  return 0;
}

void wtio_close(void* hv) {
  auto* h = static_cast<Handle*>(hv);
  if (h->map) munmap(h->map, size_t(h->map_bytes));
  if (h->fd >= 0) ::close(h->fd);
  delete h;
}

// Write a contiguous buffer to a file (atomic via rename is left to the
// caller).
int wtio_write(const char* path, const void* src, int64_t nbytes) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  const char* p = static_cast<const char*>(src);
  int64_t left = nbytes;
  while (left > 0) {
    ssize_t w = ::write(fd, p, size_t(left));
    if (w <= 0) {
      ::close(fd);
      return -1;
    }
    p += w;
    left -= w;
  }
  ::close(fd);
  return 0;
}
}
