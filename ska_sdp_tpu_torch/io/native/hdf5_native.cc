// Native HDF5 I/O layer of ska_sdp_tpu_torch (the port's copy of the JAX
// package's ska_sdp_tpu/io/native/hdf5_native.cc).
//
// Reads and writes n-D float64 / complex128 / int64 / float32 / int32 /
// complex64 / {r, i} int32 datasets, whole, as a leading-axis slice, or
// several equal-shape ones stacked; lists group members; creates files;
// defaults the ".h5" extension; reports a dataset's stored kind; and
// overwrites an existing dataset (its link is deleted and the dataset
// written anew), so no caller needs h5py.  A compact error-code C API,
// bound from Python with ctypes.  Complex values use the {r, i} compound
// type, the in-memory and on-disk layout h5py uses, so files interoperate
// bit for bit.
//
// Build: see build.py (links the HDF5 1.10 runtime through the
// hand-declared ABI in h5_abi.h).

#include "h5_abi.h"

#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kMaxRank = 16;

// Kinds 0-2 are the pipeline's dtypes; 3-6 add plain int32, the {r, i}
// int32 compound and the float32 / complex64 pair of run-precision
// checkpoints.  The numbering is the Python bindings' _K* constants.
enum Kind : int { kF64 = 0, kC128 = 1, kI64 = 2, kF32 = 3, kI32 = 4,
                  kC64 = 5, kCI32 = 6 };

struct Lib {
  Lib() {
    H5open();
    // Route errors through return codes, not stderr spew.
    H5Eset_auto2(H5E_DEFAULT, nullptr, nullptr);
  }
};

void ensure_init() { static Lib lib; }

std::string fix_ext(const char *path) {
  std::string p(path);
  if (p.size() < 3 || p.compare(p.size() - 3, 3, ".h5") != 0) p += ".h5";
  return p;
}

// RAII id closer.
template <herr_t (*Close)(hid_t)>
struct Id {
  hid_t id;
  explicit Id(hid_t i) : id(i) {}
  ~Id() {
    if (id >= 0) Close(id);
  }
  bool ok() const { return id >= 0; }
  operator hid_t() const { return id; }
};

hid_t make_compound_pair(hid_t member, size_t member_size) {
  hid_t t = H5Tcreate(H5T_COMPOUND_ABI, 2 * member_size);
  H5Tinsert(t, "r", 0, member);
  H5Tinsert(t, "i", member_size, member);
  return t;
}

hid_t mem_type(int kind) {
  switch (kind) {
    case kF64:
      return H5T_NATIVE_DOUBLE_g;
    case kI64:
      return H5T_NATIVE_LLONG_g;
    case kC128:
      return make_compound_pair(H5T_NATIVE_DOUBLE_g, sizeof(double));
    case kF32:
      return H5T_NATIVE_FLOAT_g;
    case kI32:
      return H5T_NATIVE_INT_g;
    case kC64:
      return make_compound_pair(H5T_NATIVE_FLOAT_g, sizeof(float));
    case kCI32:
      return make_compound_pair(H5T_NATIVE_INT_g, sizeof(int));
    default:
      return -1;
  }
}

bool owned_type(int kind) {
  return kind == kC128 || kind == kC64 || kind == kCI32;
}

size_t elem_size(int kind) {
  switch (kind) {
    case kC128:
      return 16;
    case kF64:
    case kI64:
    case kC64:
    case kCI32:
      return 8;
    default:
      return 4;
  }
}

struct ListCtx {
  std::string out;
  int count = 0;
};

herr_t list_cb(hid_t, const char *name, const void *, void *op_data) {
  auto *ctx = static_cast<ListCtx *>(op_data);
  if (ctx->count) ctx->out += '\n';
  ctx->out += name;
  ctx->count++;
  return 0;
}

}  // namespace

extern "C" {

// Create (truncate) an .h5 file. Returns 0 on success.
int ska_h5_create(const char *path) {
  ensure_init();
  Id<H5Fclose> f(H5Fcreate(fix_ext(path).c_str(), H5F_ACC_TRUNC, H5P_DEFAULT,
                           H5P_DEFAULT));
  return f.ok() ? 0 : -1;
}

// Rank of a dataset, or -1.
int ska_h5_rank(const char *path, const char *name) {
  ensure_init();
  Id<H5Fclose> f(H5Fopen(fix_ext(path).c_str(), H5F_ACC_RDONLY, H5P_DEFAULT));
  if (!f.ok()) return -1;
  Id<H5Dclose> d(H5Dopen2(f, name, H5P_DEFAULT));
  if (!d.ok()) return -1;
  Id<H5Sclose> s(H5Dget_space(d));
  if (!s.ok()) return -1;
  return H5Sget_simple_extent_ndims(s);
}

// Dims (length = rank) into dims_out. Returns rank or -1.
int ska_h5_dims(const char *path, const char *name, long long *dims_out) {
  ensure_init();
  Id<H5Fclose> f(H5Fopen(fix_ext(path).c_str(), H5F_ACC_RDONLY, H5P_DEFAULT));
  if (!f.ok()) return -1;
  Id<H5Dclose> d(H5Dopen2(f, name, H5P_DEFAULT));
  if (!d.ok()) return -1;
  Id<H5Sclose> s(H5Dget_space(d));
  if (!s.ok()) return -1;
  int rank = H5Sget_simple_extent_ndims(s);
  if (rank < 0 || rank > kMaxRank) return -1;
  hsize_t dims[kMaxRank];
  if (H5Sget_simple_extent_dims(s, dims, nullptr) < 0) return -1;
  for (int i = 0; i < rank; ++i) dims_out[i] = static_cast<long long>(dims[i]);
  return rank;
}

// The kind (see enum Kind) a dataset's stored type reads as at its own
// width: float -> kF32 / kF64, integer -> kI32 (<= 4 bytes) / kI64, an
// {r, i} compound -> kCI32 (integer members) / kC64 / kC128.  -1: no such
// dataset; -2: a type of no kind.
int ska_h5_kind(const char *path, const char *name) {
  ensure_init();
  Id<H5Fclose> f(H5Fopen(fix_ext(path).c_str(), H5F_ACC_RDONLY, H5P_DEFAULT));
  if (!f.ok()) return -1;
  Id<H5Dclose> d(H5Dopen2(f, name, H5P_DEFAULT));
  if (!d.ok()) return -1;
  Id<H5Tclose> t(H5Dget_type(d));
  if (!t.ok()) return -2;
  size_t size = H5Tget_size(t);
  switch (H5Tget_class(t)) {
    case H5T_FLOAT_ABI:
      return size == 4 ? kF32 : kF64;
    case H5T_INTEGER_ABI:
      return size <= 4 ? kI32 : kI64;
    case H5T_COMPOUND_ABI: {
      int r = H5Tget_member_index(t, "r");
      if (r < 0 || H5Tget_member_index(t, "i") < 0) return -2;
      Id<H5Tclose> m(H5Tget_member_type(t, static_cast<unsigned>(r)));
      if (!m.ok()) return -2;
      int cls = H5Tget_class(m);
      if (cls == H5T_INTEGER_ABI) return kCI32;
      if (cls == H5T_FLOAT_ABI) return H5Tget_size(m) == 4 ? kC64 : kC128;
      return -2;
    }
    default:
      return -2;
  }
}

// Read a whole dataset into buf (caller sizes it from ska_h5_dims).
// kind: 0 = float64, 1 = complex128 ({r,i} f64 compound), 2 = int64,
// 3 = float32, 4 = int32, 5 = complex64 ({r,i} f32), 6 = {r,i} int32.
int ska_h5_read(const char *path, const char *name, int kind, void *buf) {
  ensure_init();
  Id<H5Fclose> f(H5Fopen(fix_ext(path).c_str(), H5F_ACC_RDONLY, H5P_DEFAULT));
  if (!f.ok()) return -1;
  Id<H5Dclose> d(H5Dopen2(f, name, H5P_DEFAULT));
  if (!d.ok()) return -1;
  hid_t t = mem_type(kind);
  if (t < 0) return -2;
  herr_t err = H5Dread(d, t, H5S_ALL, H5S_ALL, H5P_DEFAULT, buf);
  if (owned_type(kind)) H5Tclose(t);
  return err < 0 ? -3 : 0;
}

// Read `count` equal-shape datasets (names joined by '\n') into one
// contiguous buffer, stacking along a new leading axis.
int ska_h5_read_stacked(const char *path, const char *names_joined, int count,
                        int kind, long long elems_each, void *buf) {
  ensure_init();
  Id<H5Fclose> f(H5Fopen(fix_ext(path).c_str(), H5F_ACC_RDONLY, H5P_DEFAULT));
  if (!f.ok()) return -1;
  hid_t t = mem_type(kind);
  if (t < 0) return -2;
  size_t esz = elem_size(kind);
  char *dst = static_cast<char *>(buf);
  const char *cur = names_joined;
  int rc = 0;
  for (int i = 0; i < count; ++i) {
    const char *end = std::strchr(cur, '\n');
    std::string nm = end ? std::string(cur, end - cur) : std::string(cur);
    Id<H5Dclose> d(H5Dopen2(f, nm.c_str(), H5P_DEFAULT));
    if (!d.ok()) {
      rc = -3;
      break;
    }
    if (H5Dread(d, t, H5S_ALL, H5S_ALL, H5P_DEFAULT, dst) < 0) {
      rc = -4;
      break;
    }
    dst += static_cast<size_t>(elems_each) * esz;
    cur = end ? end + 1 : cur;
  }
  if (owned_type(kind)) H5Tclose(t);
  return rc;
}

// Read a leading-axis slice rows [start, start+count) of a dataset into buf
// via an H5Sselect_hyperslab file-space selection (out-of-core and sharded
// ingest).
int ska_h5_read_slice(const char *path, const char *name, int kind,
                      long long start, long long count, void *buf) {
  ensure_init();
  Id<H5Fclose> f(H5Fopen(fix_ext(path).c_str(), H5F_ACC_RDONLY, H5P_DEFAULT));
  if (!f.ok()) return -1;
  Id<H5Dclose> d(H5Dopen2(f, name, H5P_DEFAULT));
  if (!d.ok()) return -1;
  Id<H5Sclose> fs(H5Dget_space(d));
  if (!fs.ok()) return -1;
  int rank = H5Sget_simple_extent_ndims(fs);
  if (rank < 1 || rank > kMaxRank) return -2;
  hsize_t dims[kMaxRank];
  if (H5Sget_simple_extent_dims(fs, dims, nullptr) < 0) return -2;
  if (start < 0 || count < 0 ||
      static_cast<hsize_t>(start + count) > dims[0])
    return -5;
  hsize_t h_start[kMaxRank] = {0};
  hsize_t h_count[kMaxRank];
  h_start[0] = static_cast<hsize_t>(start);
  h_count[0] = static_cast<hsize_t>(count);
  for (int i = 1; i < rank; ++i) h_count[i] = dims[i];
  if (H5Sselect_hyperslab(fs, H5S_SELECT_SET_ABI, h_start, nullptr, h_count,
                          nullptr) < 0)
    return -3;
  Id<H5Sclose> ms(H5Screate_simple(rank, h_count, nullptr));
  if (!ms.ok()) return -3;
  hid_t t = mem_type(kind);
  if (t < 0) return -2;
  herr_t err = H5Dread(d, t, ms, fs, H5P_DEFAULT, buf);
  if (owned_type(kind)) H5Tclose(t);
  return err < 0 ? -4 : 0;
}

// Create or overwrite a dataset (intermediate groups auto-created; an
// existing link at `name` is deleted first).
int ska_h5_write(const char *path, const char *name, int kind, int rank,
                 const long long *dims, const void *data) {
  ensure_init();
  std::string p = fix_ext(path);
  hid_t fid = H5Fopen(p.c_str(), H5F_ACC_RDWR, H5P_DEFAULT);
  if (fid < 0) fid = H5Fcreate(p.c_str(), H5F_ACC_TRUNC, H5P_DEFAULT, H5P_DEFAULT);
  Id<H5Fclose> f(fid);
  if (!f.ok()) return -1;
  if (rank < 0 || rank > kMaxRank) return -2;
  hsize_t hdims[kMaxRank];
  for (int i = 0; i < rank; ++i) hdims[i] = static_cast<hsize_t>(dims[i]);
  Id<H5Sclose> s(H5Screate_simple(rank, hdims, nullptr));
  if (!s.ok()) return -3;
  hid_t t = mem_type(kind);
  if (t < 0) return -4;
  Id<H5Pclose> lcpl(H5Pcreate(H5P_CLS_LINK_CREATE_ID_g));
  H5Pset_create_intermediate_group(lcpl, 1);
  // H5Lexists fails (< 0) when a parent group is missing: nothing to delete
  if (H5Lexists(f, name, H5P_DEFAULT) > 0 &&
      H5Ldelete(f, name, H5P_DEFAULT) < 0) {
    if (owned_type(kind)) H5Tclose(t);
    return -7;
  }
  hid_t did = H5Dcreate2(f, name, t, s, lcpl, H5P_DEFAULT, H5P_DEFAULT);
  int rc = 0;
  if (did < 0) {
    rc = -5;
  } else {
    Id<H5Dclose> d(did);
    if (H5Dwrite(d, t, H5S_ALL, H5S_ALL, H5P_DEFAULT, data) < 0) rc = -6;
  }
  if (owned_type(kind)) H5Tclose(t);
  return rc;
}

// List group members, '\n'-joined into out (capacity out_len).
// Returns member count, or -1 (open failure) / -2 (buffer too small).
int ska_h5_list_group(const char *path, const char *group, char *out,
                      long long out_len) {
  ensure_init();
  Id<H5Fclose> f(H5Fopen(fix_ext(path).c_str(), H5F_ACC_RDONLY, H5P_DEFAULT));
  if (!f.ok()) return -1;
  Id<H5Gclose> g(H5Gopen2(f, group, H5P_DEFAULT));
  if (!g.ok()) return -1;
  ListCtx ctx;
  hsize_t idx = 0;
  if (H5Literate(g, H5_INDEX_NAME, H5_ITER_INC, &idx, list_cb, &ctx) < 0)
    return -1;
  if (static_cast<long long>(ctx.out.size()) + 1 > out_len) return -2;
  std::memcpy(out, ctx.out.c_str(), ctx.out.size() + 1);
  return ctx.count;
}

}  // extern "C"
