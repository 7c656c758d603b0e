// The checkpoint reader's data plane: parallel file reads for safetensors loading.
//
// The port's own copy of native/stload.cpp (the JAX package's bridge builds that file
// into native/; this one is built by flux_fp8_api_tpu_torch/utils/native_io.py into
// build/native/). The reference reaches a native (Rust) safetensors loader for its
// 12-24 GB checkpoints (util.py:8, flux_model.py:722); here the Python side parses the
// (tiny) JSON header and hands a tensor's byte range to this library, which fans
// pread() calls across threads, saturating NVMe or page-cache bandwidth without
// holding the GIL, and can advise the kernel to prefetch the file. Host I/O with the
// same bytes as the mmap path, not a device kernel: where it cannot be built,
// utils/safetensors_io.py reads through its mmap.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

// Read [offset, offset+size) from path into dest using n_threads parallel
// pread calls. Returns 0 on success, -errno on failure.
int stload_read(const char* path, uint64_t offset, uint64_t size, void* dest,
                int n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;

  if (n_threads < 1) n_threads = 1;
  if (n_threads > 64) n_threads = 64;
  const uint64_t kMinChunk = 8ull << 20;  // 8MB floor per thread
  // ceiling division: a floored chunk would spawn n_threads+1 workers for any
  // size not divisible by n_threads, exceeding the documented cap by one
  uint64_t chunk =
      (size + static_cast<uint64_t>(n_threads) - 1) / static_cast<uint64_t>(n_threads);
  if (chunk < kMinChunk) chunk = kMinChunk;
  int threads = static_cast<int>((size + chunk - 1) / chunk);
  if (threads < 1) threads = 1;

  std::atomic<int> err{0};
  std::vector<std::thread> workers;
  workers.reserve(threads);
  for (int t = 0; t < threads; ++t) {
    workers.emplace_back([&, t]() {
      uint64_t begin = static_cast<uint64_t>(t) * chunk;
      if (begin >= size) return;
      uint64_t end = begin + chunk;
      if (end > size) end = size;
      char* out = static_cast<char*>(dest) + begin;
      uint64_t pos = begin;
      while (pos < end) {
        ssize_t got = pread(fd, out + (pos - begin), end - pos,
                            static_cast<off_t>(offset + pos));
        if (got < 0) {
          if (errno == EINTR) continue;
          err.store(-errno);
          return;
        }
        if (got == 0) {  // unexpected EOF
          err.store(-EIO);
          return;
        }
        pos += static_cast<uint64_t>(got);
      }
    });
  }
  for (auto& w : workers) w.join();
  close(fd);
  return err.load();
}

// Hint the kernel to prefetch the file sequentially. Returns 0 or -errno.
int stload_prefetch(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    int e = -errno;
    close(fd);
    return e;
  }
  (void)posix_fadvise(fd, 0, st.st_size, POSIX_FADV_WILLNEED);
  close(fd);
  return 0;
}

// Version tag so the Python wrapper can detect ABI drift.
int stload_abi_version() { return 1; }

}  // extern "C"
