// Native BAL-format loader (C ABI, loaded from Python via ctypes).
//
// A copy of the JAX package's gbp_poplar_tpu/native/balio.cpp, the host-side
// counterpart of the reference's data layer (ba/dataio.cpp:17-65
// BALProblem::LoadFile): same file format — header "n_keyframes n_points
// n_edges", shared pinhole intrinsics "fx fy cx cy", one "camID lmkID u v"
// line per edge, then 6*n_keyframes + 3*n_points initial parameters —
// parsed with a single read() + pointer-walking strtod instead of per-value
// fscanf or Python tokenising.
//
// Two-phase API so Python owns all allocations:
//   gbp_bal_open(path)          -> opaque handle (parses the whole file)
//   gbp_bal_header(h, out[3])   -> n_keyframes, n_points, n_edges
//   gbp_bal_fill(h, ...)        -> copy into caller-provided buffers
//   gbp_bal_close(h)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 (native/balio_native.py builds it
// on first use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct BalData {
  int64_t n_kf = 0, n_pts = 0, n_edges = 0;
  double k[4] = {0, 0, 0, 0};  // fx fy cx cy
  std::vector<uint32_t> cam_idx;
  std::vector<uint32_t> lmk_idx;
  std::vector<double> meas;       // [n_edges * 2]
  std::vector<double> cam_means;  // [n_kf * 6]
  std::vector<double> lmk_means;  // [n_pts * 3]
};

// Parse every whitespace-separated token as a double in one pass.
bool parse_file(const char* path, BalData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return false;
  }
  std::fclose(f);
  buf[size] = '\0';

  char* p = buf.data();
  char* end = buf.data() + size;
  auto next = [&](double* v) -> bool {
    char* q;
    *v = std::strtod(p, &q);
    if (q == p) return false;
    p = q;
    return true;
  };

  double hv[3];
  for (double* v : {&hv[0], &hv[1], &hv[2]})
    if (!next(v)) return false;
  out->n_kf = static_cast<int64_t>(hv[0]);
  out->n_pts = static_cast<int64_t>(hv[1]);
  out->n_edges = static_cast<int64_t>(hv[2]);
  if (out->n_kf <= 0 || out->n_pts <= 0 || out->n_edges <= 0) return false;
  for (int i = 0; i < 4; ++i)
    if (!next(&out->k[i])) return false;

  out->cam_idx.resize(out->n_edges);
  out->lmk_idx.resize(out->n_edges);
  out->meas.resize(out->n_edges * 2);
  for (int64_t e = 0; e < out->n_edges; ++e) {
    double c, l, u, v;
    if (!next(&c) || !next(&l) || !next(&u) || !next(&v)) return false;
    out->cam_idx[e] = static_cast<uint32_t>(c);
    out->lmk_idx[e] = static_cast<uint32_t>(l);
    out->meas[2 * e] = u;
    out->meas[2 * e + 1] = v;
  }
  out->cam_means.resize(out->n_kf * 6);
  for (double& v : out->cam_means)
    if (!next(&v)) return false;
  out->lmk_means.resize(out->n_pts * 3);
  for (double& v : out->lmk_means)
    if (!next(&v)) return false;
  // Strict: the TUM layout must consume EVERY token. Leftover tokens mean
  // a different layout (e.g. an original-BAL file, whose 9-param cameras
  // leave 3*n_kf - 4 extras) or a corrupted file — mis-parsing either as
  // TUM would silently shift all values; fail so the caller's NumPy parser
  // can disambiguate by exact token count.
  double extra;
  if (next(&extra)) return false;
  (void)end;
  return true;
}

}  // namespace

extern "C" {

void* gbp_bal_open(const char* path) {
  auto* d = new BalData();
  if (!parse_file(path, d)) {
    delete d;
    return nullptr;
  }
  return d;
}

void gbp_bal_header(void* handle, int64_t* out3, double* k4) {
  auto* d = static_cast<BalData*>(handle);
  out3[0] = d->n_kf;
  out3[1] = d->n_pts;
  out3[2] = d->n_edges;
  std::memcpy(k4, d->k, 4 * sizeof(double));
}

void gbp_bal_fill(void* handle, uint32_t* cam_idx, uint32_t* lmk_idx,
                  double* meas, double* cam_means, double* lmk_means) {
  auto* d = static_cast<BalData*>(handle);
  std::memcpy(cam_idx, d->cam_idx.data(), d->n_edges * sizeof(uint32_t));
  std::memcpy(lmk_idx, d->lmk_idx.data(), d->n_edges * sizeof(uint32_t));
  std::memcpy(meas, d->meas.data(), d->n_edges * 2 * sizeof(double));
  std::memcpy(cam_means, d->cam_means.data(), d->n_kf * 6 * sizeof(double));
  std::memcpy(lmk_means, d->lmk_means.data(), d->n_pts * 3 * sizeof(double));
}

void gbp_bal_close(void* handle) { delete static_cast<BalData*>(handle); }

}  // extern "C"
