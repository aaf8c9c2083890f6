// Hand-written declarations of the part of the HDF5 1.10 C ABI that
// hdf5_native.cc calls.
//
// The native layer compiles against the HDF5 *runtime* library alone (no
// development headers): this file declares the public-ABI subset it needs,
// with the types and enum values of the versioned HDF5 1.10 ABI (hid_t is
// 64-bit since 1.10).  That ABI is the one of the runtime's soname
// ``.103`` (libhdf5.so.103 / libhdf5_serial.so.103); build.py links no
// other.
#pragma once

#include <cstddef>
#include <cstdint>

extern "C" {

typedef int64_t hid_t;
typedef int herr_t;
typedef unsigned long long hsize_t;
typedef int htri_t;

// --- constants -----------------------------------------------------------
static const hid_t H5P_DEFAULT = 0;
static const unsigned H5F_ACC_RDONLY = 0u;
static const unsigned H5F_ACC_RDWR = 1u;
static const unsigned H5F_ACC_TRUNC = 2u;
static const hid_t H5S_ALL = 0;
static const hid_t H5E_DEFAULT = 0;

// H5T_class_t (subset)
enum H5T_class_abi {
  H5T_INTEGER_ABI = 0,
  H5T_FLOAT_ABI = 1,
  H5T_COMPOUND_ABI = 6
};

// H5_index_t / H5_iter_order_t
enum { H5_INDEX_NAME = 0 };
enum { H5_ITER_INC = 0, H5_ITER_NATIVE = 2 };

// --- global type / property-class ids (versioned data symbols) ------------
extern hid_t H5T_NATIVE_DOUBLE_g;
extern hid_t H5T_NATIVE_FLOAT_g;
extern hid_t H5T_NATIVE_LLONG_g;   // int64 on LP64
extern hid_t H5T_NATIVE_INT_g;
extern hid_t H5P_CLS_LINK_CREATE_ID_g;

// --- library -------------------------------------------------------------
herr_t H5open(void);
herr_t H5Eset_auto2(hid_t estack, void *func, void *client_data);

// --- files ---------------------------------------------------------------
hid_t H5Fcreate(const char *name, unsigned flags, hid_t fcpl, hid_t fapl);
hid_t H5Fopen(const char *name, unsigned flags, hid_t fapl);
herr_t H5Fclose(hid_t f);

// --- groups --------------------------------------------------------------
hid_t H5Gopen2(hid_t loc, const char *name, hid_t gapl);
herr_t H5Gclose(hid_t g);

// --- links ---------------------------------------------------------------
// Only the name is read from the iteration callback; the info struct is
// opaque here.
typedef herr_t (*H5L_iterate_t)(hid_t group, const char *name,
                                const void *info, void *op_data);
herr_t H5Literate(hid_t grp, int idx_type, int order, hsize_t *idx,
                  H5L_iterate_t op, void *op_data);
htri_t H5Lexists(hid_t loc, const char *name, hid_t lapl);
herr_t H5Ldelete(hid_t loc, const char *name, hid_t lapl);

// --- dataspaces ------------------------------------------------------------
hid_t H5Screate_simple(int rank, const hsize_t *dims, const hsize_t *maxdims);
herr_t H5Sclose(hid_t s);
int H5Sget_simple_extent_ndims(hid_t s);
int H5Sget_simple_extent_dims(hid_t s, hsize_t *dims, hsize_t *maxdims);

// H5S_seloper_t (subset)
enum { H5S_SELECT_SET_ABI = 0 };
herr_t H5Sselect_hyperslab(hid_t space, int seloper, const hsize_t *start,
                           const hsize_t *stride, const hsize_t *count,
                           const hsize_t *block);

// --- datatypes -------------------------------------------------------------
hid_t H5Tcreate(int cls, size_t size);
herr_t H5Tinsert(hid_t parent, const char *name, size_t offset, hid_t member);
herr_t H5Tclose(hid_t t);
int H5Tget_class(hid_t t);           // H5T_class_t; -1 on error
size_t H5Tget_size(hid_t t);         // 0 on error
int H5Tget_member_index(hid_t t, const char *name);
hid_t H5Tget_member_type(hid_t t, unsigned member);

// --- property lists ---------------------------------------------------------
hid_t H5Pcreate(hid_t cls_id);
herr_t H5Pclose(hid_t p);
herr_t H5Pset_create_intermediate_group(hid_t lcpl, unsigned yes);

// --- datasets ---------------------------------------------------------------
hid_t H5Dopen2(hid_t loc, const char *name, hid_t dapl);
hid_t H5Dcreate2(hid_t loc, const char *name, hid_t type, hid_t space,
                 hid_t lcpl, hid_t dcpl, hid_t dapl);
herr_t H5Dclose(hid_t d);
hid_t H5Dget_space(hid_t d);
hid_t H5Dget_type(hid_t d);
herr_t H5Dread(hid_t d, hid_t memtype, hid_t memspace, hid_t filespace,
               hid_t xfer, void *buf);
herr_t H5Dwrite(hid_t d, hid_t memtype, hid_t memspace, hid_t filespace,
                hid_t xfer, const void *buf);

}  // extern "C"
