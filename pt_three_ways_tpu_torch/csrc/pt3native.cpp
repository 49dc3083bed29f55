// pt3native: native host-runtime components of the PyTorch/CUDA port
// (pt_three_ways_tpu_torch), a copy of the JAX package's csrc/pt3native.cpp
// with the same C interface:
//   * OBJ/MTL scene ingest -> SoA arrays (reference: src/util/ObjLoader.*)
//   * Morton-code spatial ordering of triangle centroids for the scene pack
//   * .raw framebuffer checkpoint merge (reference: ArrayOutput.cpp,
//     raw_to_png.cpp) in the reference's exact binary format
//
// A host library (g++, not nvcc: ops/_cuda.py builds only *.cu), loaded with
// ctypes by utils/native.py, whose Python implementations remain as
// behaviour-identical fallbacks.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Mat {
  double emission[3] = {0, 0, 0};
  double diffuse[3] = {0, 0, 0};
  double ior = 1.0;
  double reflectivity = -1.0;
  double cone = 0.0;
};

struct ObjResult {
  std::vector<double> tri_verts;  // n*9
  std::vector<int32_t> tri_mat;   // n
  std::vector<Mat> mats;          // material table (deduped)
  std::string error;
};

// tokenizer matching ObjLoaderImpl.h:24-50: whitespace fields, '#' comment
// swallows rest of line, unknown directives are errors with line numbers.
std::vector<std::string> tokenize(const std::string &line) {
  std::vector<std::string> out;
  size_t i = 0, n = line.size();
  while (i < n) {
    while (i < n && std::isspace((unsigned char)line[i])) i++;
    if (i >= n || line[i] == '#') break;
    size_t j = i;
    while (j < n && !std::isspace((unsigned char)line[j]) && line[j] != '#') j++;
    out.emplace_back(line.substr(i, j - i));
    i = j;
  }
  return out;
}

bool parseMtl(std::istream &in, std::unordered_map<std::string, Mat> &result,
              std::string &err) {
  Mat *cur = nullptr;
  int illum = 2;
  double ambient[3] = {0, 0, 0};
  auto flush = [&]() {
    if (!cur) return;
    if (illum == 3) {
      cur->reflectivity = std::sqrt(ambient[0] * ambient[0] +
                                    ambient[1] * ambient[1] +
                                    ambient[2] * ambient[2]);
    }
    cur = nullptr;
  };
  std::string line;
  int ln = 0;
  while (std::getline(in, line)) {
    ln++;
    auto f = tokenize(line);
    if (f.empty()) continue;
    const std::string &cmd = f[0];
    auto need3 = [&](double *dst) {
      if (f.size() != 4) throw std::runtime_error("Wrong number of params");
      for (int k = 0; k < 3; ++k) dst[k] = std::stod(f[k + 1]);
    };
    try {
      if (cmd == "newmtl") {
        flush();
        if (f.size() != 2) throw std::runtime_error("Wrong number of params for newmtl");
        cur = &result[f[1]];
        *cur = Mat();
      } else if (cmd == "Ke") {
        if (!cur) throw std::runtime_error("Unexpected Ke");
        need3(cur->emission);
      } else if (cmd == "Kd") {
        if (!cur) throw std::runtime_error("Unexpected Kd");
        need3(cur->diffuse);
      } else if (cmd == "Ka") {
        if (!cur) throw std::runtime_error("Unexpected Ka");
        need3(ambient);
      } else if (cmd == "Ni") {
        if (!cur) throw std::runtime_error("Unexpected Ni");
        cur->ior = std::stod(f.at(1));
      } else if (cmd == "Ns") {
        if (!cur) throw std::runtime_error("Unexpected Ns");
        // empirical highlight hack (ObjLoader.cpp:91-97)
        double val = std::stod(f.at(1)) / 100.0;
        double c = 1.0 - val;
        if (c < 0) c = 0;
        if (c > 1) c = 1;
        cur->cone = M_PI * c;
      } else if (cmd == "illum") {
        if (!cur) throw std::runtime_error("Unexpected illum");
        illum = std::stoi(f.at(1));
      } else if (cmd == "Ks" || cmd == "d") {
        // ignored
      } else {
        throw std::runtime_error("Unknown directive '" + cmd + "'");
      }
    } catch (const std::exception &e) {
      err = std::string(e.what()) + " on line " + std::to_string(ln);
      return false;
    }
  }
  flush();
  return true;
}

int64_t asIndex(const std::string &tok, size_t count) {
  long v = std::stol(tok);
  return v < 0 ? v + (long)count : v - 1;
}

ObjResult *parseObj(const char *obj_path, const char *mtl_dir) {
  auto *res = new ObjResult();
  std::ifstream in(obj_path);
  if (!in) {
    res->error = std::string("Unable to open ") + obj_path;
    return res;
  }
  std::vector<double> verts;  // 3 per vertex
  std::unordered_map<std::string, Mat> materials;
  Mat curMat;
  // material dedupe table
  std::vector<Mat> table;
  auto intern = [&](const Mat &m) -> int32_t {
    for (size_t i = 0; i < table.size(); ++i) {
      if (std::memcmp(&table[i], &m, sizeof(Mat)) == 0) return (int32_t)i;
    }
    table.push_back(m);
    return (int32_t)table.size() - 1;
  };

  std::string line;
  int ln = 0;
  while (std::getline(in, line)) {
    ln++;
    auto f = tokenize(line);
    if (f.empty()) continue;
    const std::string &cmd = f[0];
    try {
      if (cmd == "v") {
        if (f.size() != 4) throw std::runtime_error("Wrong number of params for v");
        verts.push_back(std::stod(f[1]));
        verts.push_back(std::stod(f[2]));
        verts.push_back(std::stod(f[3]));
      } else if (cmd == "f") {
        size_t nv = verts.size() / 3;
        std::vector<int64_t> idx;
        for (size_t k = 1; k < f.size(); ++k) idx.push_back(asIndex(f[k], nv));
        int32_t mid = intern(curMat);
        for (size_t k = 1; k + 1 < idx.size(); ++k) {
          int64_t tri[3] = {idx[0], idx[k], idx[k + 1]};
          for (int64_t vi : tri) {
            if (vi < 0 || (size_t)vi >= nv)
              throw std::runtime_error("vertex index out of range");
            res->tri_verts.push_back(verts[vi * 3 + 0]);
            res->tri_verts.push_back(verts[vi * 3 + 1]);
            res->tri_verts.push_back(verts[vi * 3 + 2]);
          }
          res->tri_mat.push_back(mid);
        }
      } else if (cmd == "g" || cmd == "o" || cmd == "s") {
        // ignored
      } else if (cmd == "usemtl") {
        auto it = materials.find(f.at(1));
        if (it == materials.end())
          throw std::runtime_error("Can't find material " + f.at(1));
        curMat = it->second;
      } else if (cmd == "mtllib") {
        std::string path = std::string(mtl_dir) + "/" + f.at(1);
        std::ifstream mtl(path);
        if (!mtl) throw std::runtime_error("Unable to open " + path);
        std::string err;
        if (!parseMtl(mtl, materials, err)) throw std::runtime_error(err);
      } else {
        throw std::runtime_error("Unknown directive '" + cmd + "'");
      }
    } catch (const std::exception &e) {
      res->error = std::string(e.what()) + " on line " + std::to_string(ln);
      res->tri_verts.clear();
      res->tri_mat.clear();
      table.clear();
      break;
    }
  }
  res->mats = std::move(table);
  return res;
}

// 30-bit 3D Morton code
uint32_t expandBits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

}  // namespace

extern "C" {

void *pt3_obj_parse(const char *obj_path, const char *mtl_dir) {
  return parseObj(obj_path, mtl_dir);
}

const char *pt3_obj_error(void *h) {
  auto *r = (ObjResult *)h;
  return r->error.empty() ? nullptr : r->error.c_str();
}

int64_t pt3_obj_num_tris(void *h) { return (int64_t)((ObjResult *)h)->tri_mat.size(); }
int64_t pt3_obj_num_mats(void *h) { return (int64_t)((ObjResult *)h)->mats.size(); }

// verts: [n_tris*9] f64, mat_ids: [n_tris] i32, mats: [n_mats*9] f64
// (emission3, diffuse3, ior, reflectivity, cone)
void pt3_obj_copy(void *h, double *verts, int32_t *mat_ids, double *mats) {
  auto *r = (ObjResult *)h;
  std::memcpy(verts, r->tri_verts.data(), r->tri_verts.size() * sizeof(double));
  std::memcpy(mat_ids, r->tri_mat.data(), r->tri_mat.size() * sizeof(int32_t));
  for (size_t i = 0; i < r->mats.size(); ++i) {
    const Mat &m = r->mats[i];
    double *dst = mats + i * 9;
    dst[0] = m.emission[0]; dst[1] = m.emission[1]; dst[2] = m.emission[2];
    dst[3] = m.diffuse[0]; dst[4] = m.diffuse[1]; dst[5] = m.diffuse[2];
    dst[6] = m.ior; dst[7] = m.reflectivity; dst[8] = m.cone;
  }
}

void pt3_obj_free(void *h) { delete (ObjResult *)h; }

// Morton-order n points [n*3] f64 -> order[n] (permutation, ascending code).
void pt3_morton_order(const double *pts, int64_t n, int32_t *order) {
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n; ++i)
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], pts[i * 3 + k]);
      hi[k] = std::max(hi[k], pts[i * 3 + k]);
    }
  std::vector<std::pair<uint32_t, int32_t>> keyed(n);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t code = 0;
    uint32_t xyz[3];
    for (int k = 0; k < 3; ++k) {
      double range = hi[k] - lo[k];
      double t = range > 0 ? (pts[i * 3 + k] - lo[k]) / range : 0.0;
      xyz[k] = (uint32_t)std::min(1023.0, std::max(0.0, t * 1023.0));
    }
    code = (expandBits(xyz[0]) << 2) | (expandBits(xyz[1]) << 1) | expandBits(xyz[2]);
    keyed[i] = {code, (int32_t)i};
  }
  std::stable_sort(keyed.begin(), keyed.end());
  for (int64_t i = 0; i < n; ++i) order[i] = keyed[i].second;
}

// .raw checkpoint merge (reference format, ArrayOutput.cpp:66-110):
// header {u32 sig=1, u32 ver=1, u32 h, u32 w}, then per pixel 3xf64 + u32.
// Returns 0 on success; on failure writes a message into err. Each file's
// pixels are read, and the merge written, in one call (per-pixel stream
// calls made it slower than numpy's merge).
constexpr size_t kPixelBytes = 3 * sizeof(double) + sizeof(uint32_t);

int32_t pt3_raw_merge(const char **paths, int32_t n_files, const char *out_path,
                      char *err, int32_t errlen) {
  auto fail = [&](const std::string &m) {
    std::snprintf(err, errlen, "%s", m.c_str());
    return (int32_t)1;
  };
  if (n_files <= 0) return fail("no input files");
  uint32_t W = 0, H = 0;
  std::vector<double> sums;
  std::vector<uint64_t> counts;
  for (int32_t fi = 0; fi < n_files; ++fi) {
    std::ifstream in(paths[fi], std::ios::binary);
    if (!in) return fail(std::string("Unable to open ") + paths[fi]);
    uint32_t hdr[4];
    in.read((char *)hdr, sizeof(hdr));
    if (!in) return fail(std::string("Unable to read from ") + paths[fi]);
    if (hdr[0] != 1) return fail(std::string("Bad file ") + paths[fi] + " : bad signature");
    if (hdr[1] != 1) return fail(std::string("Bad file ") + paths[fi] + " : bad version");
    uint32_t h = hdr[2], w = hdr[3];
    if (fi == 0) {
      H = h; W = w;
      sums.assign((size_t)W * H * 3, 0.0);
      counts.assign((size_t)W * H, 0);
    } else if (h != H || w != W) {
      return fail("Two differently-sized arrays were attempted to be combined");
    }
    // the pixels in one read (a pixel is 3 doubles and a u32, packed)
    std::vector<char> buf((size_t)W * H * kPixelBytes);
    in.read(buf.data(), (std::streamsize)buf.size());
    if (!in) return fail(std::string("Unable to read from ") + paths[fi]);
    for (size_t p = 0; p < (size_t)W * H; ++p) {
      double v[3];
      uint32_t c;
      std::memcpy(v, buf.data() + p * kPixelBytes, sizeof(v));
      std::memcpy(&c, buf.data() + p * kPixelBytes + sizeof(v), sizeof(c));
      sums[p * 3 + 0] += v[0];
      sums[p * 3 + 1] += v[1];
      sums[p * 3 + 2] += v[2];
      counts[p] += c;
    }
  }
  std::ofstream out(out_path, std::ios::binary);
  if (!out) return fail(std::string("Unable to open ") + out_path);
  uint32_t hdr[4] = {1, 1, H, W};
  out.write((const char *)hdr, sizeof(hdr));
  std::vector<char> buf((size_t)W * H * kPixelBytes);
  for (size_t p = 0; p < (size_t)W * H; ++p) {
    uint32_t c = (uint32_t)std::min<uint64_t>(counts[p], 0xFFFFFFFFull);
    std::memcpy(buf.data() + p * kPixelBytes, &sums[p * 3], 3 * sizeof(double));
    std::memcpy(buf.data() + p * kPixelBytes + 3 * sizeof(double), &c, sizeof(c));
  }
  out.write(buf.data(), (std::streamsize)buf.size());
  if (!out) return fail(std::string("Unable to write ") + out_path);
  return 0;
}

}  // extern "C"
