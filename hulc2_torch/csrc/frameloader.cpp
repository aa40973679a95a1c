// Native frame loader: parallel .npz entry extraction into caller buffers.
//
// The port's version of native/frameloader.cpp (the JAX package's), host
// code: the hot loop of the training path without the device store -- open a
// per-frame .npz, locate a named entry, copy (or inflate) its npy payload --
// runs here in C++ threads with no GIL, writing straight into a
// caller-provided contiguous window buffer. Bound with ctypes by
// hulc2_torch/data/native_loader.py.
//
// Format notes:
// - .npz is a ZIP archive; we walk the local file headers sequentially (the
//   layout numpy writes), handling stored (0) and deflated (8) entries.
// - entry payloads are .npy files: magic \x93NUMPY, 1 version byte pair,
//   2- or 4-byte header length, then raw little-endian data.
// - unlike the JAX package's copy, which reads the whole file for every key,
//   the walk reads only the headers and seeks past the entries it does not
//   want, and a stored entry's data is read straight into the caller's row:
//   a frame's small keys cost a few hundred bytes of reads, and its images
//   reach the (pinned) batch buffer without an intermediate copy.
//
// Build (hulc2_torch/kernels/build.py, into build/kernels/):
//   g++ -O3 -shared -fPIC -std=c++17 frameloader.cpp -o libframeloader-<hash>.so -lz -lpthread
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

uint16_t rd16(const unsigned char* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const unsigned char* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// n bytes at offset off of fd into dst; false on a read error or end of file
bool read_at(int fd, void* dst, size_t n, int64_t off) {
  unsigned char* p = static_cast<unsigned char*>(dst);
  while (n > 0) {
    ssize_t got = pread(fd, p, n, static_cast<off_t>(off));
    if (got < 0 && errno == EINTR) continue;
    if (got <= 0) return false;
    p += got;
    n -= static_cast<size_t>(got);
    off += got;
  }
  return true;
}

// Offset and length of the data of an npy file whose first bytes are `head`
// (at least 12, or the whole file when shorter); -6 on a bad header.
int npy_data(const unsigned char* head, size_t npy_size, size_t* data_off, size_t* data_size) {
  if (npy_size < 10 || std::memcmp(head, "\x93NUMPY", 6) != 0) return -6;
  size_t hlen_off = 10, hlen = rd16(head + 8);
  if (head[6] != 1) {  // versions 2 and 3: a 4-byte header length
    if (npy_size < 12) return -6;
    hlen_off = 12;
    hlen = rd32(head + 8);
  }
  if (hlen_off + hlen > npy_size) return -6;
  *data_off = hlen_off + hlen;
  *data_size = npy_size - hlen_off - hlen;
  return 0;
}

// Find the zip entry named `key` or "<key>.npy" (numpy's naming) in the
// open file fd of `file_size` bytes and read its npy data into `out`, at
// most `out_cap` bytes. Returns the data's bytes or a negative error code.
int64_t extract_entry(int fd, int64_t file_size, const char* key, unsigned char* out,
                      int64_t out_cap, std::vector<unsigned char>& scratch) {
  const size_t key_len = std::strlen(key);
  std::vector<unsigned char> meta;
  unsigned char hdr[30];
  int64_t off = 0;

  while (off + 30 <= file_size && read_at(fd, hdr, 30, off) && rd32(hdr) == 0x04034b50) {
    uint16_t flags = rd16(hdr + 6);
    uint16_t method = rd16(hdr + 8);
    uint64_t comp_size = rd32(hdr + 18);
    uint64_t uncomp_size = rd32(hdr + 22);
    uint16_t name_len = rd16(hdr + 26);
    uint16_t extra_len = rd16(hdr + 28);
    meta.resize(size_t(name_len) + extra_len);
    if (!read_at(fd, meta.data(), meta.size(), off + 30)) return -2;
    const char* name = reinterpret_cast<const char*>(meta.data());
    const unsigned char* extra = meta.data() + name_len;
    const int64_t payload = off + 30 + name_len + extra_len;
    // numpy writes zip64 placeholders: sizes 0xFFFFFFFF with the real values
    // in the zip64 extra field (header id 0x0001: uncomp u64, comp u64)
    if (comp_size == 0xFFFFFFFFu || uncomp_size == 0xFFFFFFFFu) {
      const unsigned char* q = extra;
      while (q + 4 <= extra + extra_len) {
        uint16_t id = rd16(q);
        uint16_t sz = rd16(q + 2);
        if (id == 0x0001 && sz >= 16) {
          uncomp_size = rd32(q + 4) | (uint64_t(rd32(q + 8)) << 32);
          comp_size = rd32(q + 12) | (uint64_t(rd32(q + 16)) << 32);
          break;
        }
        q += 4 + sz;
      }
      if (comp_size == 0xFFFFFFFFu) return -8;  // zip64 extra missing
    }
    if (flags & 0x8) return -3;  // streaming descriptors unsupported (numpy doesn't emit them)
    if (payload + static_cast<int64_t>(comp_size) > file_size) return -2;

    bool match = name_len >= key_len && std::memcmp(name, key, key_len) == 0 &&
                 (name_len == key_len ||
                  (name_len == key_len + 4 && std::memcmp(name + key_len, ".npy", 4) == 0));
    if (!match) {
      off = payload + static_cast<int64_t>(comp_size);
      continue;
    }
    size_t data_off = 0, data_size = 0;
    if (method == 0) {  // stored: parse the npy header, then read the data into out
      unsigned char head[12];
      size_t n = comp_size < sizeof(head) ? static_cast<size_t>(comp_size) : sizeof(head);
      if (!read_at(fd, head, n, payload)) return -2;
      int rc = npy_data(head, static_cast<size_t>(comp_size), &data_off, &data_size);
      if (rc != 0) return rc;
      if (static_cast<int64_t>(data_size) > out_cap) return -7;
      if (!read_at(fd, out, data_size, payload + static_cast<int64_t>(data_off))) return -2;
      return static_cast<int64_t>(data_size);
    }
    if (method != 8) return -5;
    scratch.resize(static_cast<size_t>(comp_size + uncomp_size));
    unsigned char* comp = scratch.data();
    unsigned char* npy = comp + comp_size;
    if (!read_at(fd, comp, static_cast<size_t>(comp_size), payload)) return -2;
    z_stream zs{};
    inflateInit2(&zs, -MAX_WBITS);  // raw deflate
    zs.next_in = comp;
    zs.avail_in = static_cast<unsigned>(comp_size);
    zs.next_out = npy;
    zs.avail_out = static_cast<unsigned>(uncomp_size);
    int zrc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (zrc != Z_STREAM_END) return -4;
    int rc = npy_data(npy, static_cast<size_t>(uncomp_size), &data_off, &data_size);
    if (rc != 0) return rc;
    if (static_cast<int64_t>(data_size) > out_cap) return -7;
    std::memcpy(out, npy + data_off, data_size);
    return static_cast<int64_t>(data_size);
  }
  return -1;  // not found
}

// extract_entry on the file at `path`; -10 when it cannot be opened
int64_t load_entry(const char* path, const char* key, unsigned char* out, int64_t out_cap,
                   std::vector<unsigned char>& scratch) {
  int fd = open(path, O_RDONLY | O_CLOEXEC);
  if (fd < 0) return -10;
  struct stat st;
  int64_t rc = fstat(fd, &st) == 0 ? extract_entry(fd, st.st_size, key, out, out_cap, scratch)
                                   : -10;
  close(fd);
  return rc;
}

}  // namespace

extern "C" {

// Load entry `key` from each of n npz files into out (contiguous, row i at
// out + i*frame_bytes). Parallel over `n_threads`. Returns 0 on success or
// the first error code encountered; unlike the JAX package's copy, an entry
// whose payload is not exactly frame_bytes long is an error (-9).
int fl_load_frames(const char** paths, int64_t n, const char* key,
                   unsigned char* out, int64_t frame_bytes, int n_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    std::vector<unsigned char> scratch;  // a deflated entry's bytes
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n || err.load() != 0) return;
      int64_t got = load_entry(paths[i], key, out + i * frame_bytes, frame_bytes, scratch);
      if (got < 0) {
        err.store(static_cast<int>(got));
        return;
      }
      if (got != frame_bytes) {  // a short entry would leave the row's tail unwritten
        err.store(-9);
        return;
      }
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return err.load();
}

// Probe a single entry's payload size (for buffer allocation). Returns size
// in bytes or a negative error code.
int64_t fl_probe_entry(const char* path, const char* key) {
  std::vector<unsigned char> tmp(64 << 20), scratch;  // 64 MiB cap per frame entry
  return load_entry(path, key, tmp.data(), static_cast<int64_t>(tmp.size()), scratch);
}
}
