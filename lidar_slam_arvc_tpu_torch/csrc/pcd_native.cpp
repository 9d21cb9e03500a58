// PCD parser of lidar_slam_arvc_tpu_torch (host side, plain C interface).
//
// Decodes the xyz columns of binary and binary_compressed (LZF) PCD files
// into caller-allocated float buffers, one file per thread in a batch, so
// that stage 1 and the keyframe store read thousands of scans without the
// Python parser (the role Open3D's C++ reader plays for the reference,
// keyframemanager/keyframe.py:41-51).  ASCII files and parse errors return
// a negative count: the caller parses those files in Python.
//
// Built at first use by io/native.py into lidar_slam_arvc_tpu_torch/_build/
// (g++ -O3 -shared -fPIC -pthread -std=c++17) and loaded with ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// libLZF decompression (PCL binary_compressed payloads).
// Returns bytes written, or 0 on malformed input / overflow.
size_t lzf_decompress(const uint8_t* in, size_t in_len,
                      uint8_t* out, size_t out_len) {
  size_t i = 0, o = 0;
  while (i < in_len) {
    uint32_t ctrl = in[i++];
    if (ctrl < 32) {              // literal run of ctrl+1 bytes
      uint32_t run = ctrl + 1;
      if (i + run > in_len || o + run > out_len) return 0;
      memcpy(out + o, in + i, run);
      i += run;
      o += run;
    } else {                      // back reference
      uint32_t len = ctrl >> 5;
      if (len == 7) {
        if (i >= in_len) return 0;
        len += in[i++];
      }
      if (i >= in_len) return 0;
      int64_t ref = (int64_t)o - (int64_t)(((ctrl & 0x1F) << 8) + in[i++]) - 1;
      len += 2;
      if (ref < 0 || o + len > out_len) return 0;
      // overlapping copies must be byte-sequential
      for (uint32_t k = 0; k < len; ++k) out[o++] = out[ref++];
    }
  }
  return o;
}

namespace {

struct PcdHeader {
  std::vector<std::string> names;
  std::vector<int> sizes;
  std::vector<char> types;
  std::vector<int> counts;
  long points = 0;
  int data_kind = -1;  // 0 ascii, 1 binary, 2 binary_compressed
  size_t data_offset = 0;
  size_t point_step = 0;
};

bool parse_header(const uint8_t* buf, size_t len, PcdHeader* h) {
  size_t pos = 0;
  while (pos < len) {
    size_t eol = pos;
    while (eol < len && buf[eol] != '\n') ++eol;
    std::string line((const char*)buf + pos, eol - pos);
    pos = eol + 1;
    if (line.empty() || line[0] == '#') continue;
    char key[64];
    if (sscanf(line.c_str(), "%63s", key) != 1) continue;
    std::string rest = line.substr(strlen(key));
    if (!strcmp(key, "FIELDS")) {
      char name[64];
      const char* p = rest.c_str();
      int consumed;
      while (sscanf(p, "%63s%n", name, &consumed) == 1) {
        h->names.push_back(name);
        p += consumed;
      }
    } else if (!strcmp(key, "SIZE")) {
      int v, consumed;
      const char* p = rest.c_str();
      while (sscanf(p, "%d%n", &v, &consumed) == 1) {
        h->sizes.push_back(v);
        p += consumed;
      }
    } else if (!strcmp(key, "TYPE")) {
      char c;
      const char* p = rest.c_str();
      int consumed;
      while (sscanf(p, " %c%n", &c, &consumed) == 1) {
        h->types.push_back(c);
        p += consumed;
      }
    } else if (!strcmp(key, "COUNT")) {
      int v, consumed;
      const char* p = rest.c_str();
      while (sscanf(p, "%d%n", &v, &consumed) == 1) {
        h->counts.push_back(v);
        p += consumed;
      }
    } else if (!strcmp(key, "POINTS")) {
      sscanf(rest.c_str(), "%ld", &h->points);
    } else if (!strcmp(key, "DATA")) {
      char kind[32];
      sscanf(rest.c_str(), "%31s", kind);
      if (!strcmp(kind, "ascii")) h->data_kind = 0;
      else if (!strcmp(kind, "binary")) h->data_kind = 1;
      else if (!strcmp(kind, "binary_compressed")) h->data_kind = 2;
      h->data_offset = pos;
      break;
    }
  }
  if (h->counts.empty()) h->counts.assign(h->names.size(), 1);
  h->point_step = 0;
  for (size_t k = 0; k < h->names.size(); ++k)
    h->point_step += (size_t)h->sizes[k] * h->counts[k];
  return h->data_kind >= 0 && !h->names.empty()
      && h->names.size() == h->sizes.size()
      && h->names.size() == h->types.size()
      && h->names.size() == h->counts.size();
}

// Extract one float field from an interleaved (AoS) binary payload.
bool extract_field_aos(const uint8_t* data, size_t len, const PcdHeader& h,
                       size_t field_idx, long n, float* out) {
  size_t off = 0;
  for (size_t k = 0; k < field_idx; ++k)
    off += (size_t)h.sizes[k] * h.counts[k];
  if (h.types[field_idx] != 'F' || h.sizes[field_idx] != 4) return false;
  if (h.point_step * (size_t)n > len) return false;
  for (long p = 0; p < n; ++p)
    memcpy(out + p, data + p * h.point_step + off, 4);
  return true;
}

// Extract one float field from a field-contiguous (SoA) decompressed payload.
bool extract_field_soa(const uint8_t* data, size_t len, const PcdHeader& h,
                       size_t field_idx, long n, float* out) {
  size_t off = 0;
  for (size_t k = 0; k < field_idx; ++k)
    off += (size_t)h.sizes[k] * h.counts[k] * (size_t)h.points;
  if (h.types[field_idx] != 'F' || h.sizes[field_idx] != 4) return false;
  if (off + 4ul * (size_t)n > len) return false;
  memcpy(out, data + off, 4ul * (size_t)n);
  return true;
}

long read_pcd_file(const char* path, float* out_xyz, long capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf((size_t)fsize);
  if (fread(buf.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
    fclose(f);
    return -1;
  }
  fclose(f);

  PcdHeader h;
  if (!parse_header(buf.data(), buf.size(), &h)) return -2;
  int fx = -1, fy = -1, fz = -1;
  for (size_t k = 0; k < h.names.size(); ++k) {
    if (h.names[k] == "x") fx = (int)k;
    if (h.names[k] == "y") fy = (int)k;
    if (h.names[k] == "z") fz = (int)k;
  }
  if (fx < 0 || fy < 0 || fz < 0) return -3;

  long n = h.points < capacity ? h.points : capacity;
  const uint8_t* data = buf.data() + h.data_offset;
  size_t data_len = buf.size() - h.data_offset;

  std::vector<float> col((size_t)n);
  if (h.data_kind == 1) {
    for (int c = 0; c < 3; ++c) {
      int fi = c == 0 ? fx : (c == 1 ? fy : fz);
      if (!extract_field_aos(data, data_len, h, (size_t)fi, n, col.data()))
        return -4;
      for (long p = 0; p < n; ++p) out_xyz[p * 3 + c] = col[p];
    }
  } else if (h.data_kind == 2) {
    if (data_len < 8) return -4;
    uint32_t comp_len, uncomp_len;
    memcpy(&comp_len, data, 4);
    memcpy(&uncomp_len, data + 4, 4);
    if (8ul + comp_len > data_len) return -4;
    std::vector<uint8_t> dec(uncomp_len);
    if (lzf_decompress(data + 8, comp_len, dec.data(), uncomp_len) == 0
        && uncomp_len != 0)
      return -5;
    for (int c = 0; c < 3; ++c) {
      int fi = c == 0 ? fx : (c == 1 ? fy : fz);
      if (!extract_field_soa(dec.data(), dec.size(), h, (size_t)fi, n,
                             col.data()))
        return -4;
      for (long p = 0; p < n; ++p) out_xyz[p * 3 + c] = col[p];
    }
  } else {
    return -6;  // ascii handled by the python path
  }
  return n;
}

}  // namespace

// Read the xyz columns of a binary / binary_compressed PCD file.
// out_xyz must hold capacity*3 floats.  Returns points written, or <0 on
// error (-6 = ascii file: use the python fallback).
long pcd_read_xyz(const char* path, float* out_xyz, long capacity) {
  return read_pcd_file(path, out_xyz, capacity);
}

// Threaded batch load: n_files PCDs into out (n_files, capacity, 3) with
// per-file point counts in out_counts.  Files failing to parse get count<0.
// Every row past its count is zeroed (the whole row of a failed file), so
// out needs no clearing beforehand.
void pcd_read_batch(const char** paths, long n_files, float* out,
                    long* out_counts, long capacity, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> workers;
  auto work = [&](int tid) {
    for (long i = tid; i < n_files; i += n_threads) {
      float* row = out + i * capacity * 3;
      long n = read_pcd_file(paths[i], row, capacity);
      out_counts[i] = n;
      long from = n > 0 ? n : 0;
      memset(row + from * 3, 0, sizeof(float) * 3 * (size_t)(capacity - from));
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
  for (auto& w : workers) w.join();
}

}  // extern "C"
