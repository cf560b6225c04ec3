// Native threaded .npy batch loader for the training input pipeline.
//
// The reference feeds training with torch DataLoader worker *processes*
// doing per-sample np.load calls (train.py:93-99, fs_two/dataset.py:64-133).
// This is the native equivalent: a pool of C++ threads that parse .npy
// headers, read the payload, and scatter items into one preallocated,
// zero-padded batch buffer — one allocation, no Python in the IO path.
//
// Supports the subset the feature files use: little-endian '<f4'/'<f8'/'<i8'
// C-order arrays of rank 0..2 (v1.0/2.0 headers). Everything is converted to
// float32 on the fly; callers cast durations back to int.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Header {
  char dtype;     // 'f' float32, 'd' float64, 'q' int64, 'i' int32
  int rank;
  bool fortran;   // column-major payload (np.save writes it for
                  // F-contiguous arrays; np.load accepts both, so we must)
  long shape[2];
  long payload_offset;
};

bool parse_header(FILE* f, Header* h) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  const int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    h->payload_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    h->payload_offset = 12 + header_len;
  }
  std::string hdr(header_len, '\0');
  if (fread(&hdr[0], 1, header_len, f) != header_len) return false;

  auto find = [&](const char* key) -> size_t { return hdr.find(key); };
  size_t dp = find("'descr'");
  if (dp == std::string::npos) return false;
  size_t q1 = hdr.find('\'', dp + 7);
  size_t q2 = hdr.find('\'', q1 + 1);
  std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4") h->dtype = 'f';
  else if (descr == "<f8") h->dtype = 'd';
  else if (descr == "<i8") h->dtype = 'q';
  else if (descr == "<i4") h->dtype = 'i';
  else return false;

  h->fortran = hdr.find("'fortran_order': True") != std::string::npos;

  size_t sp = find("'shape'");
  if (sp == std::string::npos) return false;
  size_t p1 = hdr.find('(', sp);
  size_t p2 = hdr.find(')', p1);
  std::string shape = hdr.substr(p1 + 1, p2 - p1 - 1);
  h->rank = 0;
  h->shape[0] = h->shape[1] = 1;
  const char* s = shape.c_str();
  char* end = nullptr;
  for (int i = 0; i < 2; ++i) {
    long v = strtol(s, &end, 10);
    if (end == s) break;
    h->shape[h->rank++] = v;
    s = end;
    while (*s == ',' || *s == ' ') ++s;
  }
  return true;
}

// Load one .npy file as float32 into dst (capacity max_rows*cols floats,
// already zeroed). Returns rows written, or -1 on failure.
long load_one(const char* path, float* dst, long max_rows, long cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  if (!parse_header(f, &h)) {
    fclose(f);
    return -1;
  }
  long rows = h.rank == 0 ? 1 : h.shape[0];
  long width = h.rank == 2 ? h.shape[1] : 1;
  if (rows > max_rows) rows = max_rows;
  if (width > cols) width = cols;
  fseek(f, h.payload_offset, SEEK_SET);

  const long src_width = h.rank == 2 ? h.shape[1] : 1;
  const int esize = (h.dtype == 'f' || h.dtype == 'i') ? 4 : 8;

  auto elem = [&](const unsigned char* p, long i) -> float {
    switch (h.dtype) {
      case 'f': return ((const float*)p)[i];
      case 'd': return (float)((const double*)p)[i];
      case 'q': return (float)((const int64_t*)p)[i];
      default:  return (float)((const int32_t*)p)[i];
    }
  };

  if (h.fortran && h.rank == 2 && src_width > 1) {
    // Column-major payload: element (r, c) lives at c*shape[0] + r, so the
    // whole payload is read and gathered (feature files are small).
    const long src_rows = h.shape[0];
    std::vector<unsigned char> buf((size_t)src_rows * src_width * esize);
    if (fread(buf.data(), 1, buf.size(), f) != buf.size()) {
      fclose(f);
      return -1;
    }
    for (long r = 0; r < rows; ++r)
      for (long c = 0; c < width; ++c)
        dst[r * cols + c] = elem(buf.data(), c * src_rows + r);
    fclose(f);
    return rows;
  }

  std::vector<unsigned char> rowbuf((size_t)src_width * esize);
  for (long r = 0; r < rows; ++r) {
    if (fread(rowbuf.data(), 1, rowbuf.size(), f) != rowbuf.size()) {
      fclose(f);
      return -1;
    }
    float* out = dst + r * cols;
    for (long c = 0; c < width; ++c) out[c] = elem(rowbuf.data(), c);
  }
  fclose(f);
  return rows;
}

}  // namespace

// Load n files into a zero-padded (n, max_rows, cols) float32 batch with a
// thread pool. lengths[i] receives the row count (or -1 on failure).
extern "C" void load_npy_batch(const char** paths, int n, float* batch,
                               long max_rows, long cols, long* lengths,
                               int n_threads) {
  if (n_threads < 1) n_threads = 1;
  memset(batch, 0, sizeof(float) * (size_t)n * max_rows * cols);
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      lengths[i] = load_one(paths[i], batch + (size_t)i * max_rows * cols,
                            max_rows, cols);
    }
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Batched native YIN over many utterances (thread pool), declared in f0.cpp.
extern "C" int yin_f0_native(const float* wav, int n, int sr, int hop,
                             int frame_len, float f0_floor, float f0_ceil,
                             float threshold, float* out_f0, int max_frames);

extern "C" void yin_f0_batch(const float** wavs, const int* lens, int n_utts,
                             int sr, int hop, int frame_len, float f0_floor,
                             float f0_ceil, float threshold, float* out_f0,
                             int max_frames, int* out_n_frames,
                             int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n_utts) return;
      out_n_frames[i] = yin_f0_native(
          wavs[i], lens[i], sr, hop, frame_len, f0_floor, f0_ceil, threshold,
          out_f0 + (size_t)i * max_frames, max_frames);
    }
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}
